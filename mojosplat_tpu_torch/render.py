"""End-to-end render: SH colour -> projection -> binning -> rasterization.

Counterpart of ``mojosplat_tpu.render.render_gaussians``, differentiable
on both routes: SH colour and projection by plain autograd, the blend and
the slot gather by the kernels' backward on the ``"cuda"`` route.
``features`` is (N, C) RGB (``sh_degree=None``) or (N, K, C) SH
coefficients.

Not ported yet, and raising ``NotImplementedError``: ``viewport_rows``,
``means2d_offset`` and ``absgrad_sink``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.binning import BinningAux, bin_gaussians_to_tiles
from .ops.projection import project_gaussians
from .ops.rasterization import RasterAux, rasterize_gaussians
from .ops.sh import sh_to_color


class RenderAux(NamedTuple):
    binning: BinningAux
    raster: RasterAux


def render_gaussians(
    means3d: torch.Tensor,  # (N, 3) world coordinates
    scales: torch.Tensor,  # (N, 3) log-space scales
    quats: torch.Tensor,  # (N, 4) wxyz quaternions
    opacities: torch.Tensor,  # (N,) post-activation opacities
    features: torch.Tensor,  # (N, C) RGB or (N, K, C) SH coefficients
    camera: Camera,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
    return_depth: bool = False,
    viewport_rows=None,
    means2d_offset=None,
    absgrad_sink=None,
):
    """Render 3D gaussians to an (H, W, C) image.

    ``return_depth=True`` also returns the (H, W) accumulated depth
    sum_i(w_i * z_i), blended as an extra channel through the same blend.
    With ``return_aux`` the last element is a ``RenderAux`` of counters.
    """
    for name, value in (("viewport_rows", viewport_rows),
                        ("means2d_offset", means2d_offset),
                        ("absgrad_sink", absgrad_sink)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet")

    if sh_degree is None:
        if features.ndim != 2:
            raise ValueError(
                f"RGB features must be (N, C), got {tuple(features.shape)}; pass "
                "sh_degree for SH coefficients"
            )
        colors = features
    else:
        if features.ndim != 3:
            raise ValueError(f"SH features must be (N, K, C), got {tuple(features.shape)}")
        colors = sh_to_color(features, means3d, camera.position, sh_degree)

    num_channels = colors.shape[-1]
    if background_color is None:
        background = torch.zeros((num_channels,), dtype=colors.dtype, device=colors.device)
    else:
        background = torch.as_tensor(
            background_color, dtype=colors.dtype, device=colors.device
        )
        if background.shape != (num_channels,):
            raise ValueError(
                f"Background color channels {tuple(background.shape)} must match "
                f"feature channels ({num_channels},)"
            )
    if opacities.shape != (means3d.shape[0],):
        raise ValueError(
            f"opacities must be (N,) = ({means3d.shape[0]},), got "
            f"{tuple(opacities.shape)}"
        )

    proj = project_gaussians(means3d, scales, quats, opacities, camera, config)
    if config.antialiased:
        opacities = opacities * proj.compensations

    binning = bin_gaussians_to_tiles(
        proj.means2d, proj.radii, proj.depths, camera.H, camera.W, config
    )
    if return_depth:
        colors = torch.cat([colors, proj.depths[:, None].to(colors.dtype)], dim=-1)
        background = torch.cat([background, background.new_zeros((1,))])
    image, raster_aux = rasterize_gaussians(
        proj.means2d, proj.conics, colors, opacities, background, binning,
        camera.H, camera.W, config,
    )
    out = (image,)
    if return_depth:
        out = (image[..., :num_channels], image[..., num_channels])
    if return_aux:
        out = out + (RenderAux(binning=binning.aux, raster=raster_aux),)
    return out[0] if len(out) == 1 else out
