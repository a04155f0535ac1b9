"""Multi-process parallelism over ``torch.distributed``: the mesh, the
sharded render and projection (camera-DP, tile-row-SP, gaussian rows), and
the gaussian-sharded all-to-all pipeline (``gauss_sharded``).

Counterpart of ``mojosplat_tpu.parallel``. The sharded training steps over
a (``"data"``, ``"tile"``) mesh are ``train.train_step_sharded`` and
``train.train_step_sharded_surfel``.
"""

from .gauss_sharded import (
    make_gauss_mesh,
    render_gaussians_sharded,
    train_step_gauss_sharded,
)
from .multihost import init_multihost, is_primary
from .sharding import (
    make_mesh,
    project_gaussians_sharded,
    render_batch_sharded,
)

__all__ = [
    "make_mesh",
    "make_gauss_mesh",
    "init_multihost",
    "is_primary",
    "render_batch_sharded",
    "render_gaussians_sharded",
    "project_gaussians_sharded",
    "train_step_gauss_sharded",
]
