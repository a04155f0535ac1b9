"""Tile blend forward (kernel B1) and the packed slot gather.

Port of the forward of ``mojosplat_tpu.ops.raster_pallas``:

  - ``gather_tile_data`` packs the per-gaussian columns x, y, conic a/b/c,
    opacity and cp = max(4, C) channels into a field-major (6 + cp, N)
    array and gathers the slot table's columns with ONE ``index_select``
    (an XLA gather in the reference package, not a Pallas kernel).
  - ``raster_tiles`` blends each tile's first ``counts[t]`` slots front to
    back and returns (n_tiles, cp + 1, ts * ts), channel-major: the
    premultiplied channels, then the final transmittance.

``raster_tiles`` runs the CUDA kernel (``csrc/raster_fwd.cu``) on a CUDA
tensor and ``raster_tiles_plain`` (the chunked-cumprod recurrence of the
reference's XLA blender) on a CPU tensor. The backward kernel is not ported
yet, so neither is differentiable.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import RenderConfig
from .rasterization import _blend_chunk, _pixel_alphas, tile_pixel_centers

_MIN_CHANNELS = 4  # rgb + one aux (depth or zero pad), as in the reference
MAX_CHANNELS = 8  # the CUDA kernel's accumulator width


def gather_tile_data(means2d, conics, colors, opacities, slot_gids) -> torch.Tensor:
    """(6 + cp, n_slots) f32 field-major packed rows for the slot table.

    Slots past a tile's count hold clamped ids; the blend never reads them.
    """
    N = means2d.shape[0]
    C = colors.shape[-1]
    cp = max(_MIN_CHANNELS, C)
    cols = [
        means2d[:, 0], means2d[:, 1],
        conics[:, 0], conics[:, 1], conics[:, 2],
        opacities,
    ] + [colors[:, c] for c in range(C)]
    cols = [c.to(torch.float32) for c in cols]
    cols += [torch.zeros((N,), dtype=torch.float32, device=means2d.device)] * (cp - C)
    packed = torch.stack(cols, dim=0)  # (6 + cp, N)
    safe = slot_gids.reshape(-1).clamp(0, max(N - 1, 0)).to(torch.int64)
    return packed.index_select(1, safe)


def raster_tiles_plain(pdata, counts, ts: int, tw: int, config: RenderConfig):
    """Plain PyTorch version of the tile blend forward."""
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    cp = rows - 6
    P = ts * ts
    K = config.chunk_size
    pd = pdata.reshape(rows, n_tiles, cap)
    out = torch.empty((n_tiles, cp + 1, P), dtype=torch.float32, device=pdata.device)
    group = config.tile_batch or max(n_tiles, 1)
    lane = torch.arange(K, device=pdata.device)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        px, py = tile_pixel_centers(tiles, ts, tw, torch.float32)  # (G, P)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=pdata.device)
        done = torch.zeros((G, P), dtype=torch.bool, device=pdata.device)
        acc = torch.zeros((G, P, cp), dtype=torch.float32, device=pdata.device)
        for k0 in range(0, cap, K):
            chunk = pd[:, tiles, k0 : k0 + K]  # (rows, G, K)
            valid = (k0 + lane[: chunk.shape[-1]])[None, :] < counts[tiles, None]
            alpha = _pixel_alphas(
                px, py, chunk[0:2].permute(1, 2, 0), chunk[2:5].permute(1, 2, 0),
                chunk[5], valid, config,
            )
            T, done, acc = _blend_chunk(
                T, done, acc, alpha, chunk[6:].permute(1, 2, 0),
                config.transmittance_eps,
            )
        out[g0 : g0 + G] = torch.cat([acc, T[..., None]], dim=-1).transpose(1, 2)
    return out


def raster_tiles(pdata, counts, ts: int, tw: int, config: RenderConfig):
    """Blend each tile's slots; (n_tiles, cp + 1, ts * ts) f32.

    Counts a launch in ``raster_tiles.launches``.
    """
    if pdata.device.type == "cpu":
        return raster_tiles_plain(pdata, counts, ts, tw, config)
    _kernels.require(pdata, "pdata", torch.float32, 2)
    _kernels.require(counts, "counts", torch.int32, 1)
    if counts.device != pdata.device:
        raise ValueError("pdata and counts must be on one device")
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    if not _MIN_CHANNELS <= rows - 6 <= MAX_CHANNELS:
        raise ValueError(
            f"the blend kernel takes {_MIN_CHANNELS}..{MAX_CHANNELS} channels, "
            f"got {rows - 6}"
        )
    if ts * ts > 1024:
        raise ValueError(f"the blend kernel takes tile_size <= 32, got {ts}")
    if n_tiles == 0 or pdata.shape[1] % n_tiles:
        raise ValueError(f"pdata width {pdata.shape[1]} is not n_tiles * cap")
    cap = pdata.shape[1] // n_tiles
    out = torch.empty((n_tiles, rows - 5, ts * ts), dtype=torch.float32,
                      device=pdata.device)
    _kernels.launch(
        "raster_fwd_launch", pdata.device, pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        config.transmittance_eps, out.data_ptr(),
    )
    raster_tiles.launches += 1
    return out


raster_tiles.launches = 0
