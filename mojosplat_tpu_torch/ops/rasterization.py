"""Tiled, depth-ordered alpha-compositing rasterization (PyTorch).

Counterpart of ``mojosplat_tpu.ops.rasterization``. Every pixel applies the
front-to-back rule

    for each gaussian g (depth order):
        alpha = min(opacity * exp(-sigma), 0.999)
        skip if sigma < 0 or alpha < 1/255
        next_T = T * (1 - alpha); stop if next_T <= 1e-4
        pix += color * alpha * T;  T = next_T
    pix += T * background

Two routes:

  - ``"torch"``: the reference's XLA blender in plain tensor code. A dense
    (n_tiles, tile_capacity) gaussian-id table is scattered from the sorted
    lists, and chunks of ``chunk_size`` slots are blended with a cumulative
    product along the chunk (``_blend_chunk``), all tiles at once (or
    ``tile_batch`` at a time). The blender (``rasterize_torch_generic``)
    takes the alpha model as a function: the 3DGS conic here, the 2DGS
    ray/disk response in ``surfel.py``.
  - ``"cuda"``: the reference's Pallas route. The slot table is cut from
    the sorted list (kernel B5, ``slice_cuda``), the slot fields are packed
    with one gather, and the blend kernel B1 (``raster_cuda``) walks each
    pixel's slots. Its gradient comes from the blend backward B2 and the
    gather's adjoint, a stable sort plus the segment sum B3 over the slots
    the blend reads; the binning outputs are integers and carry none. On CPU tensors every kernel runs
    its plain version.

``rasterize_dense_oracle`` is the reference's O(H*W*N) oracle: a global
depth sort and an analytic tile-membership test, sharing no binning or
table code with the routes, for tests to hold both routes to.

An ``absgrad_sink`` (zero (N, 2)) collects, per gaussian, the sum over
tiles of |d loss / d means2d restricted to that tile|: on the ``"torch"``
route through a tap on every (tile, slot) centre (``_AbsTap``), on the
``"cuda"`` route through two extra columns of the gather's adjoint.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from .binning import BinningResult, num_tiles


class RasterAux(NamedTuple):
    """Per-pixel final transmittance plus the tile-capacity drop counter."""

    final_transmittance: torch.Tensor  # (H, W)
    tile_overflow: torch.Tensor  # int32: slots dropped by tile_capacity


def tile_pixel_centers(tiles: torch.Tensor, ts: int, tw: int, dtype):
    """Pixel centres (+0.5) of the given flat tile ids, pixel p = row * ts +
    col within the tile. Returns (px, py), each (len(tiles), ts * ts)."""
    p = torch.arange(ts * ts, device=tiles.device)
    tile_y, tile_x = tiles // tw, tiles % tw
    px = (tile_x[:, None] * ts + (p % ts)[None, :]).to(dtype) + 0.5
    py = (tile_y[:, None] * ts + (p // ts)[None, :]).to(dtype) + 0.5
    return px, py


class _AbsTap(torch.autograd.Function):
    """Identity on ``means_k`` (``sink_k`` is zero by contract) whose
    backward also hands |cotangent| to ``sink_k``: one (tile, slot) centre's
    tile-summed gradient, taken absolute before the sink's gather sums it
    over tiles (the reference's ``_abs_tap``)."""

    @staticmethod
    def forward(ctx, means_k, sink_k):
        return means_k + sink_k

    @staticmethod
    def backward(ctx, ct):
        return ct, ct.abs()


def _pixel_terms(px, py, means_k, conics_k, opac_k, valid_k, config):
    """The per-(pixel, slot) terms of the alpha rule for K gaussians at P
    pixels: (alpha, keep, raw, e, dx, dy), each (..., P, K), with alpha
    zeroed where skipped, raw = opacity * e and e = exp(-sigma).

    px, py: (..., P); means_k (..., K, 2); conics_k (..., K, 3);
    opac_k, valid_k: (..., K).
    """
    dx = means_k[..., None, :, 0] - px[..., :, None]
    dy = means_k[..., None, :, 1] - py[..., :, None]
    a = conics_k[..., None, :, 0]
    b = conics_k[..., None, :, 1]
    c = conics_k[..., None, :, 2]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    e = torch.exp(-sigma)
    raw = opac_k[..., None, :] * e
    alpha = torch.clamp(raw, max=config.max_alpha)
    keep = valid_k[..., None, :] & (sigma >= 0.0) & (alpha >= config.alpha_threshold)
    return torch.where(keep, alpha, torch.zeros_like(alpha)), keep, raw, e, dx, dy


def _pixel_alphas(px, py, means_k, conics_k, opac_k, valid_k, config):
    """Alphas (..., P, K) of K gaussians at P pixels, zeroed where skipped."""
    return _pixel_terms(px, py, means_k, conics_k, opac_k, valid_k, config)[0]


def _chunk_transmittance(T_in, done_in, alpha, eps):
    """The stop rule over one chunk: (applied, eff_alpha, excl, trans,
    done_out), where excl (..., P, K) is the product of (1 - eff_alpha)
    over the slots before each slot of the chunk, trans (..., P) that
    product over the whole chunk (T_out = T_in * trans).

    T_in, done_in: (..., P); alpha: (..., P, K) already zeroed for skipped
    slots.
    """
    # T is non-increasing along the chunk, so ``T_after > eps`` reproduces
    # the sequential stop exactly: the slot that would take T to <= eps is
    # itself not applied.
    T_after = T_in[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
    applied = (T_after > eps) & ~done_in[..., None]
    eff_alpha = torch.where(applied, alpha, torch.zeros_like(alpha))
    one_minus_eff = 1.0 - eff_alpha
    excl = torch.cat(
        [torch.ones_like(eff_alpha[..., :1]),
         torch.cumprod(one_minus_eff, dim=-1)[..., :-1]],
        dim=-1,
    )
    trans = torch.prod(one_minus_eff, dim=-1)
    done_out = done_in | (T_after[..., -1] <= eps)
    return applied, eff_alpha, excl, trans, done_out


def _blend_chunk(T_in, done_in, accum_in, alpha, colors_chunk, eps,
                 vals=None, accum_vals_in=None):
    """One chunk of the front-to-back recurrence, vectorized over pixels.

    T_in, done_in: (..., P); accum_in: (..., P, C); alpha: (..., P, K)
    already zeroed for skipped slots; colors_chunk: (..., K, C). With
    ``vals`` (..., P, K, V), per-pixel values of each slot (a surfel's
    ray-intersection depth), blended with the same weights into
    ``accum_vals_in`` (..., P, V).
    Returns updated (T, done, accum[, accum_vals]).
    """
    _, eff_alpha, excl, trans, done_out = _chunk_transmittance(T_in, done_in, alpha, eps)
    weights = eff_alpha * (T_in[..., None] * excl)
    accum = accum_in + torch.matmul(weights, colors_chunk)
    if vals is None:
        return T_in * trans, done_out, accum
    accum_vals = accum_vals_in + torch.einsum("...pk,...pkv->...pv", weights, vals)
    return T_in * trans, done_out, accum, accum_vals


def build_tile_table(binning: BinningResult, tile_capacity: int):
    """Dense (n_tiles, tile_capacity) gaussian-id table from the sorted
    lists; padding and overflow slots are -1. Returns (table, overflow)."""
    th, tw, _ = binning.tile_ranges.shape
    n_tiles = th * tw
    ranges = binning.tile_ranges.reshape(n_tiles, 2)
    starts = ranges[:, 0]
    counts = ranges[:, 1] - ranges[:, 0]
    device = binning.gaussian_ids.device

    M = binning.gaussian_ids.shape[0]
    t = binning.tile_ids.to(torch.int64)  # padding entries have t == n_tiles
    e = torch.arange(M, device=device)
    rank = e - starts[t.clamp(0, max(n_tiles - 1, 0))]
    ok = (t < n_tiles) & (rank >= 0) & (rank < tile_capacity)
    dump = n_tiles * tile_capacity  # one extra slot takes every dropped entry
    dest = torch.where(ok, t * tile_capacity + rank, torch.full_like(t, dump))
    table = torch.full((dump + 1,), -1, dtype=torch.int32, device=device)
    table.scatter_(0, dest, binning.gaussian_ids)
    overflow = torch.clamp(counts - tile_capacity, min=0).sum().to(torch.int32)
    return table[:dump].reshape(n_tiles, tile_capacity), overflow


def _assemble(x, th, tw, ts, img_height, img_width):
    """(n_tiles, c, ts * ts) channel-major tiles -> (H, W, c) image."""
    channels = x.shape[1]
    img = x.reshape(th, tw, channels, ts, ts).permute(0, 3, 1, 4, 2)
    return img.reshape(th * ts, tw * ts, channels)[:img_height, :img_width]


def rasterize_gaussians(
    means2d: torch.Tensor,  # (N, 2)
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C)
    opacities: torch.Tensor,  # (N,)
    background: torch.Tensor,  # (C,)
    binning: BinningResult,
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    absgrad_sink: torch.Tensor | None = None,  # (N, 2) zeros
) -> tuple[torch.Tensor, RasterAux]:
    """Rasterize binned gaussians to an (H, W, C) image."""
    ts = config.tile_size
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    C = colors.shape[-1]

    if config.raster_impl == "cuda":
        # Imported here: raster_cuda imports this module's blend helpers.
        from .raster_cuda import gather_tile_data, raster_tiles
        from .slice_cuda import segment_slice_gather

        cap = config.tile_capacity
        ranges = binning.tile_ranges.reshape(n_tiles, 2)
        starts = ranges[:, 0].contiguous()
        raw_counts = ranges[:, 1] - ranges[:, 0]
        counts = torch.clamp(raw_counts, 0, cap).to(torch.int32)
        tile_overflow = torch.clamp(raw_counts - cap, min=0).sum().to(torch.int32)
        slot_gids = segment_slice_gather(binning.gaussian_ids, starts, cap)
        pdata = gather_tile_data(means2d, conics, colors, opacities, slot_gids, counts,
                                 absgrad_sink)
        out = raster_tiles(pdata, counts, ts, tw, config)
        T_tiles = out[:, max(4, C), :]  # transmittance follows the channels
        out_tiles = out[:, :C, :] + T_tiles[:, None, :] * background[None, :, None]
        image = _assemble(out_tiles.to(colors.dtype), th, tw, ts, img_height, img_width)
        final_T = _assemble(T_tiles[:, None, :], th, tw, ts, img_height, img_width)
        return image, RasterAux(final_transmittance=final_T[..., 0], tile_overflow=tile_overflow)
    if config.raster_impl != "torch":
        raise ValueError(f"Unknown raster_impl: {config.raster_impl!r}")

    def alpha_fn(px, py, safe, valid):
        means_k = means2d[safe]
        if absgrad_sink is not None:
            means_k = _AbsTap.apply(means_k, absgrad_sink[safe])
        return _pixel_alphas(px, py, means_k, conics[safe], opacities[safe], valid, config)

    return rasterize_torch_generic(alpha_fn, means2d.shape[0], colors, background, binning,
                                   img_height, img_width, config)


def rasterize_torch_generic(alpha_fn, n: int, colors, background, binning,
                            img_height: int, img_width: int, config: RenderConfig,
                            n_pixel_values: int = 0):
    """The plain tiled blender with a pluggable per-primitive alpha model
    (the reference's ``rasterize_xla_generic``).

    ``alpha_fn(px, py, safe_ids, valid)`` gets the pixel centres (G, P) of
    a group of G tiles and the clamped ids and validity (G, K) of one chunk
    of their slots, and returns the (G, P, K) alphas, zeroed where skipped.
    With ``n_pixel_values = V > 0`` it returns ``(alpha, vals (G, P, K, V))``
    instead: per-pixel values of each slot, blended with the same weights
    and appended to the image as V extra channels (zero background).
    Returns the (H, W, C + V) image and ``RasterAux``.
    """
    ts = config.tile_size
    K = config.chunk_size
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    C = colors.shape[-1]
    V = n_pixel_values
    dtype = colors.dtype
    device = colors.device
    P = ts * ts

    table, tile_overflow = build_tile_table(binning, config.tile_capacity)
    out_tiles = torch.empty((n_tiles, P, C + V), dtype=dtype, device=device)
    T_tiles = torch.empty((n_tiles, P), dtype=dtype, device=device)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=device)
        px, py = tile_pixel_centers(tiles, ts, tw, dtype)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=dtype, device=device)
        done = torch.zeros((G, P), dtype=torch.bool, device=device)
        acc = torch.zeros((G, P, C), dtype=dtype, device=device)
        acc_v = torch.zeros((G, P, V), dtype=dtype, device=device)
        for k0 in range(0, config.tile_capacity, K):
            gids = table[g0 : g0 + G, k0 : k0 + K]  # (G, K)
            safe = gids.clamp(0, max(n - 1, 0)).to(torch.int64)
            if V:
                alpha, vals = alpha_fn(px, py, safe, gids >= 0)
                T, done, acc, acc_v = _blend_chunk(
                    T, done, acc, alpha, colors[safe], config.transmittance_eps, vals, acc_v)
            else:
                alpha = alpha_fn(px, py, safe, gids >= 0)
                T, done, acc = _blend_chunk(T, done, acc, alpha, colors[safe],
                                            config.transmittance_eps)
        out_tiles[g0 : g0 + G] = torch.cat([acc + T[..., None] * background, acc_v], dim=-1)
        T_tiles[g0 : g0 + G] = T

    image = _assemble(out_tiles.transpose(1, 2), th, tw, ts, img_height, img_width)
    final_T = _assemble(T_tiles[:, None, :], th, tw, ts, img_height, img_width)
    return image, RasterAux(final_transmittance=final_T[..., 0], tile_overflow=tile_overflow)


def rasterize_dense_oracle(
    means2d: torch.Tensor,  # (N, 2)
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C)
    opacities: torch.Tensor,  # (N,)
    background: torch.Tensor,  # (C,)
    depths: torch.Tensor,  # (N,)
    radii: torch.Tensor,  # (N, 2) int32
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """O(H*W*N) oracle: global depth sort + analytic tile-membership test.

    The reference's ``rasterize_dense_oracle``: independent of the binning
    sort and the tile table, so it cross-validates both routes. Every pixel
    walks all gaussians in depth order, ``chunk_size`` at a time with the
    blender's ``_pixel_alphas`` / ``_blend_chunk`` rule, keeping those
    whose tile bounds (binning's, with the same symmetric span truncation)
    hold the pixel's tile. Small scenes only (tests).
    """
    ts = config.tile_size
    th, tw = num_tiles(img_height, img_width, ts)
    N = means2d.shape[0]
    K = config.chunk_size
    dtype = colors.dtype
    device = colors.device
    C = colors.shape[-1]

    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(valid, depths, inf), stable=True)
    means_s, conics_s, colors_s = means2d[order], conics[order], colors[order]
    opac_s, valid_s = opacities[order], valid[order]
    radii_s = radii[order].to(dtype)

    # The same truncated tile bounds as binning.
    x, y = means_s[:, 0], means_s[:, 1]
    tx_min = torch.clamp(torch.floor((x - radii_s[:, 0]) / ts), 0, tw).to(torch.int32)
    tx_max = torch.clamp(torch.ceil((x + radii_s[:, 0]) / ts), 0, tw).to(torch.int32)
    ty_min = torch.clamp(torch.floor((y - radii_s[:, 1]) / ts), 0, th).to(torch.int32)
    ty_max = torch.clamp(torch.ceil((y + radii_s[:, 1]) / ts), 0, th).to(torch.int32)
    span = config.max_tile_span
    ex_x = torch.clamp(tx_max - tx_min - span, min=0)
    ex_y = torch.clamp(ty_max - ty_min - span, min=0)
    tx_min = tx_min + ex_x // 2
    tx_max = torch.minimum(tx_max - (ex_x - ex_x // 2), tx_min + span)
    ty_min = ty_min + ex_y // 2
    ty_max = torch.minimum(ty_max - (ex_y - ex_y // 2), ty_min + span)

    # The pixel grid, row-major.
    yy = torch.arange(img_height, dtype=dtype, device=device) + 0.5
    xx = torch.arange(img_width, dtype=dtype, device=device) + 0.5
    px = xx.repeat(img_height)
    py = yy.repeat_interleave(img_width)
    ptx = torch.div(px, ts, rounding_mode="floor").to(torch.int32)
    pty = torch.div(py, ts, rounding_mode="floor").to(torch.int32)
    P = img_height * img_width

    T = torch.ones((P,), dtype=dtype, device=device)
    done = torch.zeros((P,), dtype=torch.bool, device=device)
    accum = torch.zeros((P, C), dtype=dtype, device=device)
    for k0 in range(0, N, K):
        sl = slice(k0, min(k0 + K, N))
        pad = K - (sl.stop - sl.start)  # the last chunk, padded with no-ops

        def chunk(a):
            return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 1) + (0, pad))

        m, cn, cl, op = (chunk(a[sl]) for a in (means_s, conics_s, colors_s, opac_s))
        vd = chunk(valid_s[sl])
        x0, x1, y0, y1 = (chunk(a[sl]) for a in (tx_min, tx_max, ty_min, ty_max))
        member = ((ptx[:, None] >= x0[None, :]) & (ptx[:, None] < x1[None, :])
                  & (pty[:, None] >= y0[None, :]) & (pty[:, None] < y1[None, :]))
        alpha = _pixel_alphas(px, py, m, cn, op, vd, config)
        alpha = torch.where(member, alpha, torch.zeros_like(alpha))
        T, done, accum = _blend_chunk(T, done, accum, alpha, cl, config.transmittance_eps)
    out = accum + T[:, None] * background[None, :]
    return out.reshape(img_height, img_width, C)
