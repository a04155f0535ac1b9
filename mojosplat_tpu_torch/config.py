"""Render configuration: the numerical contract of the pipeline.

Same fields, defaults and checks as ``mojosplat_tpu.config.RenderConfig``,
so one config describes the same render in both packages. Two things
differ:

  - ``raster_impl`` takes ``"torch"`` (plain PyTorch tensor code, the
    counterpart of the reference package's ``"xla"`` oracle) or ``"cuda"``
    (the hand-written kernels under ``csrc/``, the counterpart of
    ``"pallas"``). On CPU tensors the ``"cuda"`` route runs each kernel's
    plain PyTorch version.
  - The fields that tune the reference package's Pallas kernels and jit
    programs (``pallas_chunk``, ``pallas_tiles_per_step``,
    ``pallas_interpret``, ``remat``, ``grad_route_bf16``) are accepted so
    that a config converts across unchanged; they have no effect here.
    ``tile_batch`` bounds how many tiles the plain blenders hold in memory
    at once, as it bounds the reference's XLA blender; it never changes a
    result.
"""

from __future__ import annotations

import dataclasses

_IMPL_FROM_JAX = {"xla": "torch", "pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- shared numerical contract (gsplat parity) ---
    tile_size: int = 16
    eps2d: float = 0.3
    alpha_threshold: float = 1.0 / 255.0
    max_alpha: float = 0.999
    transmittance_eps: float = 1e-4
    radius_extend: float = 3.33
    radius_clip: float = 0.0
    opacity_aware_radius: bool = True
    antialiased: bool = False
    projection_mode: str = "ewa"
    ut_alpha: float = 1.0
    ut_beta: float = 2.0
    ut_kappa: float = 0.0
    rs_iterations: int = 2

    # --- static budgets (kept so outputs and counters match) ---
    max_tile_span: int = 32
    isect_padding_multiplier: int = 4
    tight_cull: bool = False
    tile_capacity: int = 512
    chunk_size: int = 64
    tile_batch: int | None = None
    remat: bool = True

    # --- rasterizer implementation selection ---
    # "torch": plain tensor code (the oracle). "cuda": hand-written kernels.
    raster_impl: str = "torch"
    pallas_chunk: int = 128
    pallas_tiles_per_step: int = 4
    grad_route_bf16: bool = False
    pallas_interpret: bool = False

    def __post_init__(self):
        if self.tile_size <= 0:
            raise ValueError(f"tile_size must be positive, got {self.tile_size}")
        if self.tile_capacity % self.chunk_size != 0:
            raise ValueError(
                "tile_capacity must be a multiple of chunk_size, got "
                f"{self.tile_capacity} % {self.chunk_size}"
            )


DEFAULT_CONFIG = RenderConfig()


def config_from_jax(fields: dict) -> RenderConfig:
    """Port config from ``dataclasses.asdict`` of a reference-package config
    (``raster_impl`` "xla" -> "torch", "pallas" -> "cuda")."""
    fields = dict(fields)
    impl = fields.get("raster_impl", "xla")
    if impl not in _IMPL_FROM_JAX:
        raise ValueError(f"Unknown raster_impl: {impl!r}")
    fields["raster_impl"] = _IMPL_FROM_JAX[impl]
    return RenderConfig(**fields)
