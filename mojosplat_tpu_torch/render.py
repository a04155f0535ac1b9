"""End-to-end render: SH colour -> projection -> binning -> rasterization.

Counterpart of ``mojosplat_tpu.render.render_gaussians``, differentiable
on both routes: SH colour and projection by plain autograd, the blend and
the slot gather by the kernels' backward on the ``"cuda"`` route.
``features`` is (N, C) RGB (``sh_degree=None``) or (N, K, C) SH
coefficients.

Two zero (N, 2) inputs give the densification statistics their
gradients without changing the forward: ``means2d_offset`` is added to the
projected centres, so its cotangent is the view-space positional gradient;
``absgrad_sink``'s cotangent is the per-gaussian sum over tiles of the
absolute per-tile view-space gradient (AbsGS / gsplat's absgrad).

``viewport_rows=(row0, h)`` renders only the image rows ``[row0, row0 +
h)``, a slab of whole tile rows (the tile-row slab of the sharded paths in
``parallel/``): screen-space y is shifted by ``row0`` before binning, and
projection and culling are those of the full camera.
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
    visible: torch.Tensor | None = None  # (N,) bool: projected with a radius


def slab_means2d(means2d: torch.Tensor, img_height: int, viewport_rows,
                 config: RenderConfig) -> tuple[torch.Tensor, int]:
    """(means2d in the slab's rows, the slab's height) for ``viewport_rows``
    ``(row0, h)``; the full image's for None. Raises unless ``h`` is a
    multiple of the tile size."""
    if viewport_rows is None:
        return means2d, img_height
    row0, out_h = viewport_rows
    if out_h % config.tile_size != 0:
        raise ValueError(
            f"viewport height {out_h} must be a multiple of tile_size {config.tile_size}")
    shift = torch.stack([torch.zeros((), dtype=means2d.dtype, device=means2d.device),
                         torch.as_tensor(row0, dtype=means2d.dtype, device=means2d.device)])
    return means2d - shift, out_h


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
    ``means2d_offset`` and ``absgrad_sink`` are zero (N, 2) tensors whose
    gradients are the densification statistics (see the module note).
    ``viewport_rows=(row0, h)``: the (h, W, C) slab of image rows starting
    at ``row0``; ``h`` must be a multiple of the tile size.
    """
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
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    means2d, out_h = slab_means2d(proj.means2d, camera.H, viewport_rows, config)
    if config.antialiased:
        opacities = opacities * proj.compensations

    binning = bin_gaussians_to_tiles(
        means2d, proj.radii, proj.depths, out_h, camera.W, config,
        conics=proj.conics, opacities=opacities,
    )
    if return_depth:
        colors = torch.cat([colors, proj.depths[:, None].to(colors.dtype)], dim=-1)
        background = torch.cat([background, background.new_zeros((1,))])
    image, raster_aux = rasterize_gaussians(
        means2d, proj.conics, colors, opacities, background, binning,
        out_h, camera.W, config, absgrad_sink=absgrad_sink,
    )
    out = (image,)
    if return_depth:
        out = (image[..., :num_channels], image[..., num_channels])
    if return_aux:
        out = out + (RenderAux(binning=binning.aux, raster=raster_aux,
                               visible=proj.radii[:, 0] > 0),)
    return out[0] if len(out) == 1 else out
