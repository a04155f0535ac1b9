"""Tile blend forward and backward (kernels B1, B2) and the packed slot gather.

Port of ``mojosplat_tpu.ops.raster_pallas``:

  - ``gather_tile_data`` packs the per-gaussian columns x, y, conic a/b/c,
    opacity and cp = max(4, C) channels into a field-major (6 + cp, N)
    array and gathers the slot table's columns with ONE ``index_select``.
    Its adjoint (the reference's ``_gather_rows`` / ``_route_slot_grads``)
    sorts the slot ids stably with the per-slot gradient rows as payload
    and sums them per gaussian with kernel B3 (``segsum_cuda``); it never
    falls back to ``index_select``'s own backward, an atomic ``index_add_``
    on CUDA.
  - ``raster_tiles`` blends each tile's first ``counts[t]`` slots front to
    back and returns (n_tiles, cp + 1, ts * ts), channel-major: the
    premultiplied channels, then the final transmittance. Differentiable
    with respect to ``pdata``: the forward is B1 (``csrc/raster_fwd.cu``),
    which then also writes the backward's residual, and the backward is B2
    (``csrc/raster_bwd.cu``).

On CPU tensors every kernel runs its plain PyTorch version instead:
``raster_tiles_plain`` (the chunked-cumprod recurrence of the reference's
XLA blender), ``raster_tiles_bwd_plain`` (the chunked reverse walk of the
reference's ``_bwd_kernel``) and ``segment_sum_cols_plain``. On a CUDA
tensor a wrapper launches its kernel or raises.

``grad_route_bf16`` changes nothing here: the backward always computes in
f32, which meets that route's looser tolerance too.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import RenderConfig
from .rasterization import (
    _blend_chunk, _chunk_transmittance, _pixel_terms, tile_pixel_centers)
from .segsum_cuda import segment_sum_cols

_MIN_CHANNELS = 4  # rgb + one aux (depth or zero pad), as in the reference
MAX_CHANNELS = 8  # the CUDA kernels' accumulator width
RESID_CHUNK = 16  # slots per chunk of B1's residual (kResidChunk in csrc)


class _GatherRows(torch.autograd.Function):
    """``packed.index_select(1, safe)`` with a deterministic adjoint that
    routes only the first ``nfields`` rows (the rest are zero pad), keyed by
    ``keys``: ``safe``, or ``n`` (dropped by the segment sum) for a slot
    past its tile's count."""

    @staticmethod
    def forward(ctx, packed, safe, keys, nfields):
        ctx.save_for_backward(keys)
        ctx.n = packed.shape[1]
        ctx.nfields = nfields
        return packed.index_select(1, safe)

    @staticmethod
    def backward(ctx, g):
        (keys,) = ctx.saved_tensors
        keys, perm = torch.sort(keys, stable=True)
        payload = g[: ctx.nfields].index_select(1, perm).contiguous()
        summed = segment_sum_cols(payload, keys, ctx.n)
        d_packed = torch.zeros((g.shape[0], ctx.n), dtype=g.dtype, device=g.device)
        d_packed[: ctx.nfields] = summed
        return d_packed, None, None, None


def gather_tile_data(means2d, conics, colors, opacities, slot_gids,
                     counts) -> torch.Tensor:
    """(6 + cp, n_slots) f32 field-major packed rows for the slot table
    ``slot_gids``, which holds n_slots / n_tiles slots for each of the
    tiles whose ``counts`` (n_tiles,) are given.

    Slots past a tile's count hold clamped ids; the blend never reads them,
    and the adjoint drops their cotangent (the blend's backward writes
    zeros there) where the reference sums those zeros into the gaussian
    their clamped id names. No sum changes, and the padding past the sorted
    list, which clamps to one id, makes no single long segment for the
    segment sum.
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
    if torch.is_grad_enabled() and packed.requires_grad:
        cap = safe.shape[0] // max(counts.shape[0], 1)
        live = torch.arange(cap, device=counts.device)[None, :] < counts[:, None]
        keys = torch.where(live.reshape(-1), safe, N).to(torch.int32)
        return _GatherRows.apply(packed, safe, keys, 6 + C)
    return packed.index_select(1, safe)


def _geometry(tiles, pd, k0, K, counts, ts, tw, config):
    """Chunk k0 of the given tiles: its slot rows (rows, G, K) and the
    per-(pixel, slot) terms of the blend, ``_pixel_terms``' (alpha, keep,
    raw, e, dx, dy), each (G, P, K) (the reference's ``_chunk_geometry``)."""
    px, py = tile_pixel_centers(tiles, ts, tw, torch.float32)  # (G, P)
    chunk = pd[:, tiles, k0 : k0 + K]  # (rows, G, K)
    lane = torch.arange(chunk.shape[-1], device=pd.device)
    valid = (k0 + lane)[None, :] < counts[tiles, None]  # (G, K)
    terms = _pixel_terms(px, py, chunk[0:2].permute(1, 2, 0),
                         chunk[2:5].permute(1, 2, 0), chunk[5], valid, config)
    return (chunk, *terms)


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
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=pdata.device)
        done = torch.zeros((G, P), dtype=torch.bool, device=pdata.device)
        acc = torch.zeros((G, P, cp), dtype=torch.float32, device=pdata.device)
        for k0 in range(0, cap, K):
            chunk, alpha, *_ = _geometry(tiles, pd, k0, K, counts, ts, tw, config)
            T, done, acc = _blend_chunk(
                T, done, acc, alpha, chunk[6:].permute(1, 2, 0),
                config.transmittance_eps,
            )
        out[g0 : g0 + G] = torch.cat([acc, T[..., None]], dim=-1).transpose(1, 2)
    return out


def raster_tiles_bwd_plain(pdata, counts, gout, ts: int, tw: int,
                           config: RenderConfig) -> torch.Tensor:
    """Plain PyTorch version of the tile blend backward: d pdata
    (6 + cp, n_tiles * cap) from the output cotangent ``gout``
    (n_tiles, cp + 1, ts * ts).

    The reference's ``_bwd_kernel`` written out over groups of
    ``tile_batch`` tiles: a forward walk records each chunk's incoming
    transmittance and done latch, then the chunks are walked in reverse
    carrying the transmittance cotangent gt, with
    ``d_eff = cv * T_before - (S + gt * T_out) / (1 - eff)``. Only one
    chunk's (G, P, K) intermediates are alive at a time.
    """
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    cp = rows - 6
    K = config.chunk_size
    eps = config.transmittance_eps
    pd = pdata.reshape(rows, n_tiles, cap)
    d_pd = torch.zeros((rows, n_tiles, cap), dtype=torch.float32, device=pdata.device)
    group = config.tile_batch or max(n_tiles, 1)
    zero = torch.zeros((), dtype=torch.float32, device=pdata.device)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        G = tiles.shape[0]
        P = ts * ts
        T = torch.ones((G, P), dtype=torch.float32, device=pdata.device)
        done = torch.zeros((G, P), dtype=torch.bool, device=pdata.device)
        history = []
        for k0 in range(0, cap, K):
            history.append((T, done))
            _, alpha, *_ = _geometry(tiles, pd, k0, K, counts, ts, tw, config)
            *_, trans, done = _chunk_transmittance(T, done, alpha, eps)
            T = T * trans

        v = gout[g0 : g0 + G, :cp, :].transpose(1, 2)  # (G, P, cp)
        gt = gout[g0 : g0 + G, cp, :]  # (G, P)
        for i in reversed(range(len(history))):
            k0 = i * K
            t_in, done_in = history[i]
            chunk, alpha, keep, raw, e, dx, dy = _geometry(
                tiles, pd, k0, K, counts, ts, tw, config)
            applied, eff, excl, trans, _ = _chunk_transmittance(t_in, done_in, alpha, eps)
            ome = 1.0 - eff
            t_before = t_in[..., None] * excl
            w = eff * t_before
            t_out = t_in * trans

            cols = chunk[6:].permute(1, 2, 0)  # (G, K, cp)
            cv = torch.matmul(v, cols.transpose(1, 2))  # (G, P, K)
            d_cols = torch.matmul(w.transpose(1, 2), v)  # (G, K, cp)
            q = w * cv
            # S_j = sum over i > j of q_i: an exclusive reverse cumsum.
            rev = torch.cumsum(q.flip(-1), dim=-1).flip(-1)
            S = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], dim=-1)
            d_eff = cv * t_before - (S + (gt * t_out)[..., None]) / ome
            d_alpha = torch.where(applied, d_eff, zero)
            d_raw = torch.where(keep & (raw < config.max_alpha), d_alpha, zero)
            d_op = d_raw * e
            d_sigma = -d_raw * raw
            ca, cb, cc = (chunk[r][:, None, :] for r in (2, 3, 4))
            d_geo = torch.stack([
                d_sigma * (ca * dx + cb * dy),
                d_sigma * (cc * dy + cb * dx),
                0.5 * d_sigma * dx * dx,
                d_sigma * dx * dy,
                0.5 * d_sigma * dy * dy,
                d_op,
            ]).sum(dim=2)  # (6, G, K)
            d_pd[:6, g0 : g0 + G, k0 : k0 + K] = d_geo
            d_pd[6:, g0 : g0 + G, k0 : k0 + K] = d_cols.permute(2, 0, 1)
            gt = torch.sum(eff * excl * cv, dim=-1) + gt * trans
    return d_pd.reshape(rows, n_tiles * cap)


def _check_blend_args(pdata, counts, ts: int) -> int:
    """Validate the blend kernels' inputs; returns cap."""
    _kernels.require(pdata, "pdata", torch.float32, 2)
    _kernels.require(counts, "counts", torch.int32, 1)
    if counts.device != pdata.device:
        raise ValueError("pdata and counts must be on one device")
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    if not _MIN_CHANNELS <= rows - 6 <= MAX_CHANNELS:
        raise ValueError(
            f"the blend kernels take {_MIN_CHANNELS}..{MAX_CHANNELS} channels, "
            f"got {rows - 6}"
        )
    if ts * ts > 1024:
        raise ValueError(f"the blend kernels take tile_size <= 32, got {ts}")
    if n_tiles == 0 or pdata.shape[1] % n_tiles:
        raise ValueError(f"pdata width {pdata.shape[1]} is not n_tiles * cap")
    return pdata.shape[1] // n_tiles


def raster_tiles_fwd(pdata, counts, ts: int, tw: int, config: RenderConfig,
                     residual: bool):
    """(out, residual): B1 on a CUDA tensor, the plain version on a CPU
    tensor (whose residual is None: its backward recomputes). The residual
    is (tchunk, stop), written only when asked for. Counts a launch in
    ``raster_tiles.launches`` and a written residual in
    ``raster_tiles_fwd.residuals``."""
    if pdata.device.type == "cpu":
        return raster_tiles_plain(pdata, counts, ts, tw, config), None
    cap = _check_blend_args(pdata, counts, ts)
    rows, n_tiles, P = pdata.shape[0], counts.shape[0], ts * ts
    out = torch.empty((n_tiles, rows - 5, P), dtype=torch.float32, device=pdata.device)
    resid = None
    if residual:
        raster_tiles_fwd.residuals += 1
        nch = -(-cap // RESID_CHUNK)
        resid = (
            torch.empty((n_tiles, nch, P), dtype=torch.float32, device=pdata.device),
            torch.empty((n_tiles, P), dtype=torch.int32, device=pdata.device),
        )
    _kernels.launch(
        "raster_fwd_launch", pdata.device, pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        config.transmittance_eps, out.data_ptr(),
        resid[0].data_ptr() if resid else None, resid[1].data_ptr() if resid else None,
    )
    raster_tiles.launches += 1
    return out, resid


def raster_tiles_bwd(pdata, counts, gout, residual, ts: int, tw: int,
                     config: RenderConfig) -> torch.Tensor:
    """d pdata (6 + cp, n_tiles * cap) of the tile blend: B2 on CUDA
    tensors, given B1's residual; ``raster_tiles_bwd_plain`` on CPU tensors
    (residual None). Counts a launch in ``raster_tiles_bwd.launches``."""
    if pdata.device.type == "cpu":
        return raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, config)
    cap = _check_blend_args(pdata, counts, ts)
    rows, n_tiles, P = pdata.shape[0], counts.shape[0], ts * ts
    gout = gout.contiguous()
    _kernels.require(gout, "gout", torch.float32, 3)
    if tuple(gout.shape) != (n_tiles, rows - 5, P):
        raise ValueError(f"gout must be {(n_tiles, rows - 5, P)}, got {tuple(gout.shape)}")
    if residual is None:
        raise ValueError("the backward kernel needs the forward kernel's residual")
    tchunk, stop = residual
    _kernels.require(tchunk, "tchunk", torch.float32, 3)
    _kernels.require(stop, "stop", torch.int32, 2)
    if tuple(tchunk.shape) != (n_tiles, -(-cap // RESID_CHUNK), P) or \
            tuple(stop.shape) != (n_tiles, P):
        raise ValueError("the residual does not match pdata's shapes")
    d_pdata = torch.empty_like(pdata)
    _kernels.launch(
        "raster_bwd_launch", pdata.device, pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        gout.data_ptr(), tchunk.data_ptr(), stop.data_ptr(), d_pdata.data_ptr(),
    )
    raster_tiles_bwd.launches += 1
    return d_pdata


class _RasterTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pdata, counts, ts, tw, config):
        out, resid = raster_tiles_fwd(pdata, counts, ts, tw, config, residual=True)
        ctx.save_for_backward(pdata, counts, *(resid or ()))
        ctx.args = (ts, tw, config)
        return out

    @staticmethod
    def backward(ctx, gout):
        pdata, counts, *resid = ctx.saved_tensors
        d_pdata = raster_tiles_bwd(pdata, counts, gout, tuple(resid) or None, *ctx.args)
        return d_pdata, None, None, None, None


def raster_tiles(pdata, counts, ts: int, tw: int, config: RenderConfig):
    """Blend each tile's slots; (n_tiles, cp + 1, ts * ts) f32.

    Differentiable with respect to ``pdata``. When no gradient is needed
    the forward kernel writes no residual. Counts a launch in
    ``raster_tiles.launches``.
    """
    if torch.is_grad_enabled() and pdata.requires_grad:
        return _RasterTiles.apply(pdata, counts, ts, tw, config)
    return raster_tiles_fwd(pdata, counts, ts, tw, config, residual=False)[0]


raster_tiles.launches = 0
raster_tiles_fwd.residuals = 0
raster_tiles_bwd.launches = 0
