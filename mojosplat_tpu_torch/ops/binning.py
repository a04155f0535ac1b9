"""Tile binning: gaussian -> (tile, depth)-sorted intersection lists (PyTorch).

Counterpart of ``mojosplat_tpu.ops.binning.bin_gaussians_to_tiles``. Three
static budgets bound the dynamic quantities, and both drops are counted:

  1. ``max_tile_span`` caps the per-gaussian tile footprint per axis;
     larger footprints are truncated symmetrically around the centre.
  2. ``capacity`` caps the total intersection count; emission is in depth
     order, so overflow drops the farthest intersections first.
  3. Padding entries carry ``tile_id == n_tiles`` and ``gaussian_id == -1``.

Both routes share a stable depth presort of the gaussians (empty ones last)
and give the same ``gaussian_ids`` order as the reference package:

  - ``"torch"`` (the reference's oracle route): one scattered head per
    gaussian and a cumsum give each slot its owner, one row gather fetches
    the owner's fields, and a stable sort on (tile, depth) orders the slots.
  - ``"cuda"`` (the reference's Pallas route): kernel B4
    (``expand_cuda.segment_expand_offsets``) gives each slot its owner's
    fields straight from the offsets, and a stable sort on the tile key
    alone keeps the presorted depth order.

``tight_cull`` is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from .expand_cuda import segment_expand_offsets


class BinningAux(NamedTuple):
    """Observability counters (0-d int32 tensors)."""

    num_isects: torch.Tensor  # real intersections kept (<= capacity)
    capacity_overflow: torch.Tensor  # dropped because the buffer filled
    span_truncated: torch.Tensor  # tile slots lost to span capping
    tight_culled: torch.Tensor  # always 0 until tight_cull is ported


class BinningResult(NamedTuple):
    """gaussian_ids (capacity,) int32 sorted by (tile, depth), padding -1;
    tile_ids (capacity,) int32, padding n_tiles; tile_ranges
    (tiles_h, tiles_w, 2) int32 [start, end); aux counters."""

    gaussian_ids: torch.Tensor
    tile_ids: torch.Tensor
    tile_ranges: torch.Tensor
    aux: BinningAux


def isect_capacity(n_gaussians: int, config: RenderConfig) -> int:
    """Static intersection-buffer capacity for N gaussians."""
    cap = config.isect_padding_multiplier * max(int(n_gaussians), 1)
    return int(-(-cap // 1024) * 1024)


def num_tiles(img_height: int, img_width: int, tile_size: int) -> tuple[int, int]:
    """Tile grid dims, ceil(H/ts) x ceil(W/ts)."""
    return math.ceil(img_height / tile_size), math.ceil(img_width / tile_size)


def _slot_tiles(slot, g_off, g_sx, g_tx, g_ty, tw):
    """Flat tile of each slot: the k-th tile of its owner's span rectangle,
    row-major."""
    k = slot - g_off
    sx = torch.clamp(g_sx, min=1)
    ky = torch.div(k, sx, rounding_mode="floor")
    kx = k - ky * sx
    return (g_ty + ky) * tw + (g_tx + kx)


class Presorted(NamedTuple):
    """Per-gaussian binning state in depth-presort order.

    fields: (5, N) int32 rows offset (exclusive prefix sum of slot counts),
        span_x, tx_min, ty_min, original index; the input of kernel B4.
    depths: (N,) f32 sort keys (+inf for gaussians that own no slot).
    total: 0-d int32 slot demand (may exceed the capacity).
    span_truncated: 0-d int32 slots lost to span capping.
    """

    fields: torch.Tensor
    depths: torch.Tensor
    total: torch.Tensor
    span_truncated: torch.Tensor


def presort_gaussians(means2d, radii, depths, th: int, tw: int,
                      config: RenderConfig) -> Presorted:
    """Tile footprints, span truncation and the stable depth presort."""
    ts = config.tile_size
    span = config.max_tile_span
    N = means2d.shape[0]
    device = means2d.device
    i32 = torch.int32

    # Binning is index bookkeeping: no gradient flows through it.
    means2d, depths = means2d.detach(), depths.detach()
    x, y = means2d[:, 0], means2d[:, 1]
    rx = radii[:, 0].to(means2d.dtype)
    ry = radii[:, 1].to(means2d.dtype)
    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)

    # Tile-space AABB, [min, max) exclusive, clamped to the grid.
    tx_min = torch.clamp(torch.floor((x - rx) / ts), 0, tw).to(i32)
    tx_max = torch.clamp(torch.ceil((x + rx) / ts), 0, tw).to(i32)
    ty_min = torch.clamp(torch.floor((y - ry) / ts), 0, th).to(i32)
    ty_max = torch.clamp(torch.ceil((y + ry) / ts), 0, th).to(i32)

    zero = torch.zeros((), dtype=i32, device=device)
    span_x = torch.where(valid, tx_max - tx_min, zero)
    span_y = torch.where(valid, ty_max - ty_min, zero)
    orig_area = span_x * span_y

    # Symmetric truncation to the per-axis span budget.
    tx_min = tx_min + torch.clamp(span_x - span, min=0) // 2
    ty_min = ty_min + torch.clamp(span_y - span, min=0) // 2
    span_x = torch.clamp(span_x, max=span)
    span_y = torch.clamp(span_y, max=span)
    counts = span_x * span_y
    span_truncated = torch.sum(orig_area - counts).to(i32)

    # Depth presort shared by both routes: empty gaussians fold to +inf so
    # they compact to the back; NaN depths fold to the largest finite float
    # so a non-empty gaussian never lands after an empty one. Stable, so
    # equal depths keep the original-index order.
    depth_key = depths.to(torch.float32)
    depth_key = torch.where(
        torch.isnan(depth_key),
        torch.full_like(depth_key, torch.finfo(torch.float32).max),
        depth_key,
    )
    sortkey = torch.where(counts == 0, torch.full_like(depth_key, math.inf), depth_key)
    depths_p, order = torch.sort(sortkey, stable=True)
    counts_p = counts[order]
    offsets_p = torch.cumsum(counts_p, dim=0, dtype=i32) - counts_p  # exclusive
    total = offsets_p[-1] + counts_p[-1] if N > 0 else zero
    fields = torch.stack(
        [offsets_p, span_x[order], tx_min[order], ty_min[order], order.to(i32)]
    )
    return Presorted(fields, depths_p, total, span_truncated)


def bin_gaussians_to_tiles(
    means2d: torch.Tensor,  # (N, 2) pixel-space centres
    radii: torch.Tensor,  # (N, 2) int32 radii (0 => culled)
    depths: torch.Tensor,  # (N,) camera-space z
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    capacity: int | None = None,
) -> BinningResult:
    """Bin gaussians into screen tiles, depth-sorted within each tile."""
    if config.tight_cull:
        raise NotImplementedError("tight_cull is not ported yet")
    if config.raster_impl not in ("torch", "cuda"):
        raise ValueError(f"Unknown raster_impl: {config.raster_impl!r}")
    N = means2d.shape[0]
    th, tw = num_tiles(img_height, img_width, config.tile_size)
    n_tiles = th * tw
    if capacity is None:
        capacity = isect_capacity(N, config)
    # The reference package's bounds (its f32 and bit packing), kept so
    # both packages accept the same inputs.
    if N >= (1 << 24):
        raise ValueError(
            "binning packs gaussian indices in f32 (exact below 2^24); "
            f"got N = {N}"
        )
    if max(th, tw) >= (1 << 13) or config.max_tile_span >= (1 << 8):
        raise ValueError(
            "binning packs tile coords in 13 bits and spans in 8 "
            f"(grid {th}x{tw}, max_tile_span {config.max_tile_span})"
        )
    device = means2d.device
    i32 = torch.int32

    fields, depths_p, total, span_truncated = presort_gaussians(
        means2d, radii, depths, th, tw, config
    )
    slot = torch.arange(capacity, dtype=i32, device=device)
    if config.raster_impl == "cuda":
        g = segment_expand_offsets(fields, capacity)
        in_range = slot < total
        tile = _slot_tiles(slot, g[0], g[1], g[2], g[3], tw)
        tile_buf = torch.where(in_range, tile, torch.full_like(tile, n_tiles))
        gid_buf = torch.where(in_range, g[4], torch.full_like(g[4], -1))
        # Within a tile the slots are already depth-ascending (presort);
        # a stable sort on the tile key alone keeps that order.
        sorted_tile, perm = torch.sort(tile_buf, stable=True)
        sorted_gid = gid_buf[perm]
    else:
        # One head per gaussian at its offset, then a cumsum: each slot's
        # owner is the last gaussian starting at or before it. Offsets at
        # or past capacity are dropped into a spare last bin.
        head = torch.zeros(capacity + 1, dtype=i32, device=device)
        offsets = fields[0]
        head.scatter_add_(
            0, offsets.clamp(max=capacity).to(torch.int64), torch.ones_like(offsets)
        )
        rank_buf = torch.cumsum(head[:capacity], dim=0, dtype=i32) - 1
        in_range = (slot < total) & (rank_buf >= 0)
        safe_rank = rank_buf.clamp(0, max(N - 1, 0)).to(torch.int64)
        if N > 0:
            g = fields[:, safe_rank]  # one row gather of the packed fields
            g_depth = depths_p[safe_rank]
        else:
            g = torch.zeros((5, capacity), dtype=i32, device=device)
            g_depth = torch.zeros((capacity,), dtype=torch.float32, device=device)
        tile = _slot_tiles(slot, g[0], g[1], g[2], g[3], tw)
        tile_buf = torch.where(in_range, tile, torch.full_like(tile, n_tiles))
        gid_buf = torch.where(in_range, g[4], torch.full_like(g[4], -1))
        depth_buf = torch.where(in_range, g_depth, torch.full_like(g_depth, math.inf))
        # Stable lexicographic sort on (tile, depth): by depth, then by tile.
        by_depth = torch.sort(depth_buf, stable=True).indices
        by_tile = torch.sort(tile_buf[by_depth], stable=True).indices
        perm = by_depth[by_tile]
        sorted_tile = tile_buf[perm]
        sorted_gid = gid_buf[perm]

    boundaries = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, dtype=i32, device=device), out_int32=True
    )
    tile_ranges = torch.stack([boundaries[:-1], boundaries[1:]], dim=-1).reshape(th, tw, 2)

    aux = BinningAux(
        num_isects=boundaries[-1],
        capacity_overflow=torch.clamp(total - capacity, min=0).to(i32),
        span_truncated=span_truncated,
        tight_culled=torch.zeros((), dtype=i32, device=device),
    )
    return BinningResult(
        gaussian_ids=sorted_gid.contiguous(),
        tile_ids=sorted_tile.contiguous(),
        tile_ranges=tile_ranges,
        aux=aux,
    )
