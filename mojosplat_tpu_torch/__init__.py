"""mojosplat_tpu_torch: gaussian splatting in PyTorch with CUDA kernels.

A port of ``mojosplat_tpu`` (JAX/Pallas on a TPU, kept as the reference)
to PyTorch on an NVIDIA Hopper GPU. Plain tensor code is PyTorch; each
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use (``_kernels``).

Ported so far, each on the ``"torch"`` (plain) and ``"cuda"`` (kernel)
routes, forward and backward: the 3DGS render with SH colours
(``render_gaussians``, with ``tight_cull`` and the densification sinks) and
its ``train.train_step`` and ``train.train_step_with_densify_stats``; ADC
and MCMC density control (``densify``); the 2DGS surfel render with depth,
normal and distortion maps (``render_surfels``) and its
``train.train_step_surfel``; the pinhole (with lens distortion), fisheye
and orthographic cameras, the rolling shutter, the unscented projection and
pose refinement (``apply_pose_delta``) in both families; the COLMAP
capture path: the native IO (``native``), PLY, splat, PNG, COLMAP, Blender
and the compressed format (``utils``), checkpoints, the per-view
appearance modules (``bilagrid``, ``train.apply_exposure``), the sparse
depth loss, and the ``examples.train_colmap`` / ``examples.eval_colmap``
CLIs; the scene tools: TSDF fusion and marching tetrahedra
(``utils.mesh``), profiling and metrics (``utils.profiling``,
``utils.metrics``), the dense oracle
(``ops.rasterization.rasterize_dense_oracle``) and the demo CLIs
(``examples.render_sample``, ``orbit_demo``, ``viewer``,
``compress_scene``, ``extract_mesh``, ``train_demo``,
``train_surfel_demo``, ``train_blender``); multi-card training over
``torch.distributed`` (``parallel``: the tile-row slab ``viewport_rows``,
camera-DP x tile-SP with ZeRO-1 and the surfel halo exchange,
``train.train_step_sharded`` / ``train_step_sharded_surfel``, the
all-to-all gaussian-sharded pipeline, ``init_multihost``, and
``examples.benchmark_scaling``); the tools (``examples.benchmark``,
``benchmark_proj``, ``make_synth_colmap`` with the COLMAP writers of
``utils.colmap``, ``resample_sfm`` and ``record_parity``). Kernels: B1/B2
(3DGS tile blend and its backward), B3 (segment sum), B4 (slot
expansion), B5 (per-tile slot slice), B6/B7 (surfel tile blend, without
and with the maps), B8 (their backward) and B9 (the blend-variant probe,
``ops.raster_probe``). Importing this package never imports jax.
"""

from .bilagrid import apply_bilateral_grid, bilateral_grid_tv, identity_bilateral_grid
from .camera import Camera, apply_pose_delta, look_at
from .config import DEFAULT_CONFIG, RenderConfig, config_from_jax
from .render import RenderAux, render_gaussians
from .surfel import render_surfels

__all__ = [
    "Camera",
    "apply_pose_delta",
    "look_at",
    "RenderConfig",
    "DEFAULT_CONFIG",
    "config_from_jax",
    "render_gaussians",
    "render_surfels",
    "RenderAux",
    "apply_bilateral_grid",
    "bilateral_grid_tv",
    "identity_bilateral_grid",
]

__version__ = "0.1.0"
