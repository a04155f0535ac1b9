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
    ``tile_batch`` at a time).
  - ``"cuda"``: the reference's Pallas route. The slot table is cut from
    the sorted list (kernel B5, ``slice_cuda``), the slot fields are packed
    with one gather, and the blend kernel B1 (``raster_cuda``) walks each
    pixel's slots. Its gradient comes from the blend backward B2 and the
    gather's adjoint, a stable sort plus the segment sum B3 over the slots
    the blend reads; the binning outputs are integers and carry none. On CPU tensors every kernel runs
    its plain version.
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


def _blend_chunk(T_in, done_in, accum_in, alpha, colors_chunk, eps):
    """One chunk of the front-to-back recurrence, vectorized over pixels.

    T_in, done_in: (..., P); accum_in: (..., P, C); alpha: (..., P, K)
    already zeroed for skipped slots; colors_chunk: (..., K, C).
    Returns updated (T, done, accum).
    """
    _, eff_alpha, excl, trans, done_out = _chunk_transmittance(T_in, done_in, alpha, eps)
    weights = eff_alpha * (T_in[..., None] * excl)
    accum = accum_in + torch.matmul(weights, colors_chunk)
    return T_in * trans, done_out, accum


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
        pdata = gather_tile_data(means2d, conics, colors, opacities, slot_gids, counts)
        out = raster_tiles(pdata, counts, ts, tw, config)
        T_tiles = out[:, max(4, C), :]  # transmittance follows the channels
        out_tiles = out[:, :C, :] + T_tiles[:, None, :] * background[None, :, None]
        image = _assemble(out_tiles.to(colors.dtype), th, tw, ts, img_height, img_width)
        final_T = _assemble(T_tiles[:, None, :], th, tw, ts, img_height, img_width)
        return image, RasterAux(final_transmittance=final_T[..., 0], tile_overflow=tile_overflow)
    if config.raster_impl != "torch":
        raise ValueError(f"Unknown raster_impl: {config.raster_impl!r}")
    return _rasterize_torch(
        means2d, conics, colors, opacities, background, binning,
        img_height, img_width, config,
    )


def _rasterize_torch(means2d, conics, colors, opacities, background, binning,
                     img_height, img_width, config):
    """The plain tiled blender (the reference's ``rasterize_xla_generic``
    with the 3DGS conic alpha model)."""
    ts = config.tile_size
    K = config.chunk_size
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    N = means2d.shape[0]
    C = colors.shape[-1]
    dtype = colors.dtype
    device = colors.device
    P = ts * ts

    table, tile_overflow = build_tile_table(binning, config.tile_capacity)
    out_tiles = torch.empty((n_tiles, P, C), dtype=dtype, device=device)
    T_tiles = torch.empty((n_tiles, P), dtype=dtype, device=device)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=device)
        px, py = tile_pixel_centers(tiles, ts, tw, dtype)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=dtype, device=device)
        done = torch.zeros((G, P), dtype=torch.bool, device=device)
        acc = torch.zeros((G, P, C), dtype=dtype, device=device)
        for k0 in range(0, config.tile_capacity, K):
            gids = table[g0 : g0 + G, k0 : k0 + K]  # (G, K)
            safe = gids.clamp(0, max(N - 1, 0)).to(torch.int64)
            alpha = _pixel_alphas(
                px, py, means2d[safe], conics[safe], opacities[safe], gids >= 0, config
            )
            T, done, acc = _blend_chunk(
                T, done, acc, alpha, colors[safe], config.transmittance_eps
            )
        out_tiles[g0 : g0 + G] = acc + T[..., None] * background
        T_tiles[g0 : g0 + G] = T

    image = _assemble(out_tiles.transpose(1, 2), th, tw, ts, img_height, img_width)
    final_T = _assemble(T_tiles[:, None, :], th, tw, ts, img_height, img_width)
    return image, RasterAux(final_transmittance=final_T[..., 0], tile_overflow=tile_overflow)
