"""mojosplat_tpu_torch: the 3DGS render path in PyTorch with CUDA kernels.

A port of ``mojosplat_tpu`` (JAX/Pallas on a TPU, kept as the reference)
to PyTorch on an NVIDIA Hopper GPU. Plain tensor code is PyTorch; each
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use (``_kernels``).

Ported so far: the forward render of 3DGS with SH colours through
``render_gaussians`` on the ``"torch"`` (plain) and ``"cuda"`` (kernel)
routes; the kernels B1 (tile blend forward), B4 (slot expansion) and B5
(per-tile slot slice). Importing this package never imports jax.
"""

from .camera import Camera, look_at
from .config import DEFAULT_CONFIG, RenderConfig, config_from_jax
from .render import RenderAux, render_gaussians

__all__ = [
    "Camera",
    "look_at",
    "RenderConfig",
    "DEFAULT_CONFIG",
    "config_from_jax",
    "render_gaussians",
    "RenderAux",
]

__version__ = "0.1.0"
