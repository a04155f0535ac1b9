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

With ``tight_cull`` and the projection's ``conics`` and ``opacities``,
every candidate tile of a gaussian's truncated span rectangle must also
pass the conic-vs-tile peak-alpha test (``_tight_tile_masks``): a slot whose
gaussian cannot reach the blend threshold anywhere in the tile is never
emitted, and the ``tight_culled`` counter counts those slots. Each gaussian
then carries its survivor count and a bitmask of its surviving candidates
(22 bits per int32 row, up to 3 rows, so ``max_tile_span`` <= 8); a slot
decodes its tile as the k-th set bit of its owner's mask
(``_decode_mask_tile``). On the ``"cuda"`` route B4 expands the mask rows
in place of ``span_x``; on the ``"torch"`` route they ride the owner gather.
Without ``conics`` (the surfel binning) ``tight_cull`` changes nothing.
"""

from __future__ import annotations

import functools
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
    tight_culled: torch.Tensor  # AABB slots the tight test proved empty


class BinningResult(NamedTuple):
    """gaussian_ids (capacity,) int32 sorted by (tile, depth), padding -1;
    tile_ids (capacity,) int32, padding n_tiles; tile_ranges
    (tiles_h, tiles_w, 2) int32 [start, end); aux counters."""

    gaussian_ids: torch.Tensor
    tile_ids: torch.Tensor
    tile_ranges: torch.Tensor
    aux: BinningAux


# Bits of candidate mask per int32 row: the reference's bound (its f32 sort
# payloads and its expand kernel's limb reconstruction are exact below
# 2^22), kept so both packages pack the same masks.
_MASK_BITS = 22
# At most 3 mask rows, so tight culling supports max_tile_span <= 8.
_MAX_TIGHT_BITS = 3 * _MASK_BITS


def _rect_min_sigma(a, b, c, inva, invc, lx, hx, ly, hy):
    """Minimum of sigma(u, v) = 0.5 (a u^2 + c v^2) + b u v over the
    displacement rectangle [lx, hx] x [ly, hy]: 0 when the origin lies
    inside (the conic is positive-definite), else the least of the four
    edges' closed-form minima (a clamped vertex)."""
    def edge_u(u):  # fixed u, minimise over v
        v = torch.minimum(torch.maximum(-b * u * invc, ly), hy)
        return 0.5 * (a * u * u + c * v * v) + b * u * v

    def edge_v(v):
        u = torch.minimum(torch.maximum(-b * v * inva, lx), hx)
        return 0.5 * (a * u * u + c * v * v) + b * u * v

    q = torch.minimum(torch.minimum(edge_u(lx), edge_u(hx)),
                      torch.minimum(edge_v(ly), edge_v(hy)))
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    return torch.where(inside, torch.zeros_like(q), q)


def _tight_tile_masks(means2d, conics, opacities, tx_min, ty_min, span_x, span_y,
                      ts: int, span: int, alpha_threshold: float):
    """Per-gaussian survivor counts (N,) int32 and candidate bitmasks, a list
    of (N,) int32 rows with bit j = ky * span + kx of row j // _MASK_BITS set
    for a surviving candidate tile (kx, ky) of the span rectangle.

    A candidate survives iff the gaussian's peak alpha over the tile's
    pixel-centre rectangle reaches the blend threshold,
    opacity * exp(-min sigma) >= alpha_threshold: the blend's own keep
    test at the rectangle's continuous minimum, so a culled slot provably
    adds nothing to any pixel. One row of candidates (all kx) at a time.
    """
    dev = means2d.device
    mx, my = means2d[:, 0:1], means2d[:, 1:2]
    a, b, c = (conics[:, r : r + 1].to(torch.float32) for r in range(3))
    inva = 1.0 / torch.clamp(a, min=1e-12)
    invc = 1.0 / torch.clamp(c, min=1e-12)
    smax = torch.log(torch.clamp(opacities.to(torch.float32), min=1e-12)
                     / alpha_threshold)[:, None]
    n_rows = -(-span * span // _MASK_BITS)
    kx = torch.arange(span, dtype=torch.int32, device=dev)
    lx = (tx_min[:, None] + kx).to(torch.float32) * ts + 0.5 - mx  # (N, span)
    hx = lx + (ts - 1)
    in_x = kx < span_x[:, None]
    counts = torch.zeros(mx.shape[0], dtype=torch.int32, device=dev)
    masks = [torch.zeros_like(counts) for _ in range(n_rows)]
    for ky in range(span):
        ly = (ty_min[:, None] + ky).to(torch.float32) * ts + 0.5 - my  # (N, 1)
        hy = ly + (ts - 1)
        q = _rect_min_sigma(a, b, c, inva, invc, lx, hx, ly, hy)
        hit = (in_x & (ky < span_y[:, None]) & (q <= smax)).to(torch.int32)
        counts += hit.sum(dim=1, dtype=torch.int32)
        bits = [ky * span + x for x in range(span)]
        for r in range(n_rows):
            cols = [x for x, j in enumerate(bits) if j // _MASK_BITS == r]
            if cols:
                shift = torch.tensor([bits[x] % _MASK_BITS for x in cols],
                                     dtype=torch.int32, device=dev)
                masks[r] |= (hit[:, cols] << shift).sum(dim=1, dtype=torch.int32)
    return counts, masks


@functools.cache
def _select_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Lookup tables over 16-bit words w: (65536 * 16,) int32 position of
    the k-th set bit of w at w * 16 + k (16 past the last set bit), and
    (65536,) int32 popcount of w."""
    w = torch.arange(1 << 16, dtype=torch.int32, device=device)
    j = torch.arange(16, dtype=torch.int32, device=device)
    bits = (w[:, None] >> j) & 1
    before = torch.cumsum(bits, dim=1, dtype=torch.int32) - bits  # set bits before j
    select = torch.full((1 << 16, 17), 16, dtype=torch.int32, device=device)
    select.scatter_(1, torch.where(bits == 1, before, 16).to(torch.int64),
                    j.expand(1 << 16, 16).contiguous())
    return select[:, :16].reshape(-1).contiguous(), bits.sum(dim=1, dtype=torch.int32)


def _decode_mask_tile(k, mask_rows, span: int, tw: int, g_tx, g_ty):
    """Flat tile of each slot's k-th surviving candidate, the k-th set bit
    j = ky * span + kx of its owner's row-major span x span mask. The mask
    is read 16 bits at a time through ``_select_tables``: the bit is in the
    first word whose popcount exceeds what k has left. A slot with no such
    bit (only past the total, where binning masks it) decodes to j = 0."""
    select, popcount = _select_tables(k.device)
    mask = mask_rows[0]
    if len(mask_rows) > 1:  # 22 bits a row: join the rows into one int64
        mask = mask.to(torch.int64)
        for r in range(1, len(mask_rows)):
            mask = mask | (mask_rows[r].to(torch.int64) << (_MASK_BITS * r))
    rem = k
    pos = torch.zeros_like(k)
    found = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    for c in range(-(-span * span // 16)):
        word = ((mask >> (16 * c)) & 0xFFFF).to(torch.int64)
        count = popcount[word]
        take = ~found & (rem >= 0) & (rem < count)
        j = select[word * 16 + rem.clamp(0, 15).to(torch.int64)]
        pos = torch.where(take, j + 16 * c, pos)
        found |= take
        rem = rem - count
    ky = torch.div(pos, span, rounding_mode="floor")
    return (g_ty + ky) * tw + g_tx + (pos - ky * span)


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

    fields: (F, N) int32 rows, the input of kernel B4: offset (exclusive
        prefix sum of slot counts), span_x, tx_min, ty_min, original index;
        with tight culling offset, tx_min, ty_min, index, then the
        ``mask_rows`` candidate mask rows.
    depths: (N,) f32 sort keys (+inf for gaussians that own no slot).
    total: 0-d int32 slot demand (may exceed the capacity).
    span_truncated: 0-d int32 slots lost to span capping.
    tight_culled: 0-d int32 slots the tight test removed.
    mask_rows: number of mask rows (0 without tight culling).
    """

    fields: torch.Tensor
    depths: torch.Tensor
    total: torch.Tensor
    span_truncated: torch.Tensor
    tight_culled: torch.Tensor
    mask_rows: int


def presort_gaussians(means2d, radii, depths, th: int, tw: int, config: RenderConfig,
                      conics=None, opacities=None) -> Presorted:
    """Tile footprints, span truncation, tight culling (with ``conics`` and
    ``opacities`` under ``config.tight_cull``) and the stable depth
    presort."""
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
    masks = []
    tight_culled = zero
    if config.tight_cull and conics is not None and opacities is not None:
        counts, masks = _tight_tile_masks(
            means2d, conics.detach(), opacities.detach(), tx_min, ty_min, span_x, span_y,
            ts, span, config.alpha_threshold)
        tight_culled = torch.sum(span_x * span_y - counts).to(i32)

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
    if masks:
        rows = [offsets_p, tx_min[order], ty_min[order], order.to(i32)]
        rows += [m[order] for m in masks]
    else:
        rows = [offsets_p, span_x[order], tx_min[order], ty_min[order], order.to(i32)]
    return Presorted(torch.stack(rows), depths_p, total, span_truncated, tight_culled,
                     len(masks))


def bin_gaussians_to_tiles(
    means2d: torch.Tensor,  # (N, 2) pixel-space centres
    radii: torch.Tensor,  # (N, 2) int32 radii (0 => culled)
    depths: torch.Tensor,  # (N,) camera-space z
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    capacity: int | None = None,
    conics: torch.Tensor | None = None,  # (N, 3), for tight culling
    opacities: torch.Tensor | None = None,  # (N,), for tight culling
) -> BinningResult:
    """Bin gaussians into screen tiles, depth-sorted within each tile.

    With ``config.tight_cull`` and ``conics`` / ``opacities`` given, slots
    that cannot reach the blend threshold in their tile are not emitted."""
    tight = config.tight_cull and conics is not None and opacities is not None
    if tight and config.max_tile_span ** 2 > _MAX_TIGHT_BITS:
        raise ValueError(
            f"tight_cull supports max_tile_span <= 8 (candidate masks are "
            f"{_MAX_TIGHT_BITS} bits); got {config.max_tile_span}")
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

    pre = presort_gaussians(means2d, radii, depths, th, tw, config, conics, opacities)
    fields, depths_p, total = pre.fields, pre.depths, pre.total
    slot = torch.arange(capacity, dtype=i32, device=device)

    def slot_tiles(g):
        """Each slot's tile and original index from its owner's rows g."""
        if pre.mask_rows:
            tile = _decode_mask_tile(slot - g[0], g[4:], config.max_tile_span, tw, g[1], g[2])
            return tile, g[3]
        return _slot_tiles(slot, g[0], g[1], g[2], g[3], tw), g[4]

    if config.raster_impl == "cuda":
        g = segment_expand_offsets(fields, capacity)
        in_range = slot < total
        tile, gid = slot_tiles(g)
        tile_buf = torch.where(in_range, tile, torch.full_like(tile, n_tiles))
        gid_buf = torch.where(in_range, gid, torch.full_like(gid, -1))
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
            g = torch.zeros((fields.shape[0], capacity), dtype=i32, device=device)
            g_depth = torch.zeros((capacity,), dtype=torch.float32, device=device)
        tile, gid = slot_tiles(g)
        tile_buf = torch.where(in_range, tile, torch.full_like(tile, n_tiles))
        gid_buf = torch.where(in_range, gid, torch.full_like(gid, -1))
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
        span_truncated=pre.span_truncated,
        tight_culled=pre.tight_culled,
    )
    return BinningResult(
        gaussian_ids=sorted_gid.contiguous(),
        tile_ids=sorted_tile.contiguous(),
        tile_ranges=tile_ranges,
        aux=aux,
    )
