"""Tile blend forward and backward (kernels B1, B2) and the packed slot gather.

Port of ``mojosplat_tpu.ops.raster_pallas``:

  - ``gather_tile_data`` packs the per-gaussian columns x, y, conic a/b/c,
    opacity and cp = max(4, C) channels into a field-major (6 + cp, N)
    array and gathers the slot table's columns with ONE ``index_select``.
    Its adjoint (the reference's ``_gather_rows`` / ``_route_slot_grads``)
    sorts the slot ids stably and sums the per-slot gradient rows per
    gaussian with kernel B3 (``segsum_cuda``), which reads them in the
    sorted order through the sort's permutation (the reference's sort
    carries them as payload) and writes the sums into the packed gradient
    itself; it never falls back to ``index_select``'s own backward, an
    atomic ``index_add_`` on CUDA. With an ``absgrad_sink``, |d x| and |d y|
    of every slot are two more columns of the same sum, and their sums are
    the sink's gradient (the reference's ``_gather_rows_abs``).
  - ``raster_tiles`` blends each tile's first ``counts[t]`` slots front to
    back and returns (n_tiles, cp + 1, ts * ts), channel-major: the
    premultiplied channels, then the final transmittance. Differentiable
    with respect to ``pdata``: the forward is B1 (``csrc/raster_fwd.cu``),
    which then also writes the backward's residual, and the backward is B2
    (``csrc/raster_bwd.cu``). Both skip the slots that no pixel of a warp's
    pixel rows can keep; ``row_may_apply_plain`` mirrors that test, and
    ``raster_tiles_skips`` reads B1's count of the slots it skipped.

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
B1_WARP_PIXELS = 64  # consecutive pixels of a tile a B1 warp owns (kWarpPix in csrc)


class _GatherRows(torch.autograd.Function):
    """``packed.index_select(1, safe)`` with a deterministic adjoint that
    routes only the first ``nfields`` rows (the rest are zero pad), keyed by
    ``keys``: ``safe``, or ``n`` (dropped by the segment sum) for a slot
    past its tile's count. ``sink`` (zero (n, 2) or None) does not enter
    the forward; its gradient is the per-gaussian sum of |d row 0| and
    |d row 1| (x and y), two more columns of the same segment sum."""

    @staticmethod
    def forward(ctx, packed, safe, keys, nfields, sink):
        ctx.save_for_backward(keys)
        ctx.n = packed.shape[1]
        ctx.nfields = nfields
        return packed.index_select(1, safe)

    @staticmethod
    def backward(ctx, g):
        (keys,) = ctx.saved_tensors
        keys, perm = torch.sort(keys, stable=True)
        f, n, rows = ctx.nfields, ctx.n, g.shape[0]
        g = g.contiguous()
        if not ctx.needs_input_grad[4]:
            # B3 reads the slot columns in key order through perm and writes
            # the f routed rows straight into d_packed; only the pad rows
            # past them are zeroed.
            d_packed = torch.empty((rows, n), dtype=g.dtype, device=g.device)
            d_packed[f:].zero_()
            segment_sum_cols(g[:f], keys, n, perm=perm, out=d_packed[:f])
            return d_packed, None, None, None, None
        # With the sink, |d x| and |d y| are two more payload columns, put
        # first: rows [2, 2 + rows) of one buffer are then d_packed.
        cols = torch.cat([g[0:2].abs(), g[:f]])
        summed = torch.empty((2 + rows, n), dtype=g.dtype, device=g.device)
        summed[2 + f:].zero_()
        segment_sum_cols(cols, keys, n, perm=perm, out=summed[:2 + f])
        return summed[2:], None, None, None, summed[:2].T


def gather_slots(packed, slot_gids, counts, nfields: int, sink=None) -> torch.Tensor:
    """Columns ``slot_gids`` (clamped to [0, N)) of the field-major
    ``packed`` (rows, N): (rows, n_slots), n_slots / n_tiles slots for each
    of the tiles whose ``counts`` (n_tiles,) are given.

    Slots past a tile's count hold clamped ids; the blend never reads them,
    and the adjoint drops their cotangent (the blend's backward writes
    zeros there) where the reference sums those zeros into the gaussian
    their clamped id names. No sum changes, and the padding past the sorted
    list, which clamps to one id, makes no single long segment for the
    segment sum. Only the first ``nfields`` rows are routed back; the rest
    are zero pad. ``sink`` (zero (N, 2)) receives the absolute slot
    gradients of rows 0 and 1 (``_GatherRows``).
    """
    N = packed.shape[1]
    safe = slot_gids.reshape(-1).clamp(0, max(N - 1, 0)).to(torch.int64)
    grads = packed.requires_grad or (sink is not None and sink.requires_grad)
    if torch.is_grad_enabled() and grads:
        cap = safe.shape[0] // max(counts.shape[0], 1)
        live = torch.arange(cap, device=counts.device)[None, :] < counts[:, None]
        keys = torch.where(live.reshape(-1), safe, N).to(torch.int32)
        return _GatherRows.apply(packed, safe, keys, nfields, sink)
    return packed.index_select(1, safe)


def gather_tile_data(means2d, conics, colors, opacities, slot_gids,
                     counts, absgrad_sink=None) -> torch.Tensor:
    """(6 + cp, n_slots) f32 field-major packed rows x, y, conic a/b/c,
    opacity and cp = max(4, C) channels for the slot table ``slot_gids``
    (``gather_slots``, which also feeds ``absgrad_sink``)."""
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
    return gather_slots(torch.stack(cols, dim=0), slot_gids, counts, 6 + C, absgrad_sink)


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


def row_may_apply_plain(pdata, n_tiles: int, ts: int, tw: int,
                        config: RenderConfig) -> torch.Tensor:
    """(n_tiles, ceil(ts * ts / W), cap) bool, W = ``B1_WARP_PIXELS``:
    whether some pixel of B1's warp w (pixels [W w, W w + W) of the tile,
    taken as the whole pixel rows they lie in) may keep slot k. False only
    where none can.

    The plain mirror of ``ms_row_may_apply`` (``csrc/common.cuh``), each f32
    operation in the same order: along a row, sigma is convex in dx for
    a > 0, so its minimum over the row's dx range (the closed form clamped
    to it), less a margin of 1e-5 (1 + the terms' magnitude) for rounding,
    bounds every pixel's sigma; opacity * exp(-bound) below the threshold
    keeps no pixel. a <= 0, NaN and a threshold <= 0 may apply.
    """
    rows = pdata.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    dev, f32 = pdata.device, torch.float32
    pd = pdata.reshape(rows, n_tiles, cap)
    P = ts * ts
    W = B1_WARP_PIXELS
    warps = torch.arange(-(-P // W), device=dev)
    first = warps * W // ts
    last = (torch.clamp(warps * W + W, max=P) - 1) // ts
    r = torch.arange(ts, device=dev)
    in_warp = (r[None, :] >= first[:, None]) & (r[None, :] <= last[:, None])  # (nw, ts)
    thr = torch.tensor(config.alpha_threshold, dtype=f32, device=dev)
    out = torch.ones((n_tiles, warps.shape[0], cap), dtype=torch.bool, device=dev)
    if not config.alpha_threshold > 0:
        return out
    group = 64  # tiles at a time: (group, ts, cap) intermediates
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        ty, tx = tiles // tw, tiles % tw
        x_first = ((tx * ts).to(f32) + 0.5)[:, None, None]
        x_last = ((tx * ts + ts - 1).to(f32) + 0.5)[:, None, None]
        py = ((ty[:, None] * ts + r[None, :]).to(f32) + 0.5)[..., None]  # (G, ts, 1)
        mx, my, a, b, c, op = (pd[k, tiles][:, None, :] for k in range(6))  # (G, 1, cap)
        dy = my - py
        lo, hi = mx - x_last, mx - x_first
        bdy = b * dy
        t = -bdy / a
        nan_t = torch.isnan(t)
        t = torch.fmin(torch.fmax(t, lo), hi)
        sigma = 0.5 * (a * t * t + c * dy * dy) + bdy * t
        x = torch.fmax(lo.abs(), hi.abs())
        mag = 0.5 * (a * x * x + c.abs() * dy * dy) + bdy.abs() * x
        low = sigma - 1e-5 * (mag + 1.0)
        may = ~(op * torch.exp(-low) < thr) | nan_t | ~(a > 0)  # (G, ts, cap)
        out[g0 : g0 + tiles.shape[0]] = (may[:, None] & in_warp[None, :, :, None]).any(dim=2)
    return out


def skipped_pairs_plain(may, counts, stop) -> torch.Tensor:
    """(n_tiles, n_warps) int32: B1's count of the (warp, slot) pairs its
    row test skipped, from ``row_may_apply_plain``'s ``may`` and B1's
    ``stop`` (n_tiles, ts * ts). A warp tests the slots below the count in
    groups of 32, each unless all its pixels stopped before the group."""
    n_tiles, nw, cap = may.shape
    W = B1_WARP_PIXELS
    st = torch.nn.functional.pad(stop.to(torch.int64), (0, nw * W - stop.shape[1]), value=-1)
    wstop = st.reshape(n_tiles, nw, W).amax(dim=2)
    slot = torch.arange(cap, device=may.device)
    live = slot[None, :] < counts.clamp(0, cap)[:, None].to(torch.int64)  # (n_tiles, cap)
    tested = live[:, None, :] & ((slot // 32 * 32)[None, None, :] <= wstop[..., None])
    return (tested & ~may).sum(dim=2).to(torch.int32)


def stop_plain(pdata, counts, ts: int, tw: int, config: RenderConfig) -> torch.Tensor:
    """Plain version of B1's ``stop`` residual: (n_tiles, ts * ts) int32,
    each pixel's first slot whose transmittance test ends its walk, or the
    tile's count (clamped to cap)."""
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    K, P, eps = config.chunk_size, ts * ts, config.transmittance_eps
    pd = pdata.reshape(rows, n_tiles, cap)
    out = torch.empty((n_tiles, P), dtype=torch.int32, device=pdata.device)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=pdata.device)
        done = torch.zeros((G, P), dtype=torch.bool, device=pdata.device)
        stop = counts[tiles].clamp(0, cap).to(torch.int64)[:, None].expand(G, P)
        for k0 in range(0, cap, K):
            _, alpha, *_ = _geometry(tiles, pd, k0, K, counts, ts, tw, config)
            T_after = T[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
            hit = (T_after <= eps) & ~done[..., None]
            stop = torch.where(hit.any(dim=-1), k0 + hit.to(torch.int8).argmax(dim=-1), stop)
            *_, trans, done = _chunk_transmittance(T, done, alpha, eps)
            T = T * trans
        out[g0 : g0 + G] = stop.to(torch.int32)
    return out


def check_tiles(pdata, counts, ts: int) -> int:
    """Validate the tile blend kernels' common inputs; returns cap."""
    _kernels.require(pdata, "pdata", torch.float32, 2)
    _kernels.require(counts, "counts", torch.int32, 1)
    if counts.device != pdata.device:
        raise ValueError("pdata and counts must be on one device")
    n_tiles = counts.shape[0]
    if ts * ts > 1024:
        raise ValueError(f"the blend kernels take tile_size <= 32, got {ts}")
    if n_tiles == 0 or pdata.shape[1] % n_tiles:
        raise ValueError(f"pdata width {pdata.shape[1]} is not n_tiles * cap")
    return pdata.shape[1] // n_tiles


def _check_blend_args(pdata, counts, ts: int) -> int:
    """Validate the 3DGS blend kernels' inputs; returns cap."""
    cap = check_tiles(pdata, counts, ts)
    rows = pdata.shape[0]
    if not _MIN_CHANNELS <= rows - 6 <= MAX_CHANNELS:
        raise ValueError(
            f"the blend kernels take {_MIN_CHANNELS}..{MAX_CHANNELS} channels, "
            f"got {rows - 6}"
        )
    return cap


def _launch_fwd(pdata, counts, ts, tw, config, out, tchunk, stop, skipped) -> None:
    """Launch B1 on checked CUDA tensors; tchunk/stop (the residual) and
    skipped (the row test's count) may be None."""
    _kernels.launch(
        "raster_fwd_launch", pdata.device, pdata.data_ptr(), pdata.shape[0],
        counts.shape[0], pdata.shape[1] // counts.shape[0], counts.data_ptr(), ts, tw,
        config.alpha_threshold, config.max_alpha, config.transmittance_eps, out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (tchunk, stop, skipped)),
    )


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
    _launch_fwd(pdata, counts, ts, tw, config, out, *(resid or (None, None)), None)
    raster_tiles.launches += 1
    return out, resid


def raster_tiles_skips(pdata, counts, ts: int, tw: int, config: RenderConfig):
    """(skipped, stop): each B1 warp's count of the (warp, slot) pairs its
    row test skipped, (n_tiles, ceil(ts * ts / B1_WARP_PIXELS)) int32, and B1's stop
    residual (n_tiles, ts * ts). On a CUDA tensor B1 runs with its residual
    and writes the count (a launch in ``raster_tiles.launches``); on a CPU
    tensor ``skipped_pairs_plain`` counts over ``row_may_apply_plain`` and
    ``stop_plain``."""
    n_tiles = counts.shape[0]
    if pdata.device.type == "cpu":
        stop = stop_plain(pdata, counts, ts, tw, config)
        may = row_may_apply_plain(pdata, n_tiles, ts, tw, config)
        return skipped_pairs_plain(may, counts, stop), stop
    cap = _check_blend_args(pdata, counts, ts)
    rows, P = pdata.shape[0], ts * ts
    dev = pdata.device
    out = torch.empty((n_tiles, rows - 5, P), dtype=torch.float32, device=dev)
    tchunk = torch.empty((n_tiles, -(-cap // RESID_CHUNK), P), dtype=torch.float32, device=dev)
    stop = torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
    skipped = torch.empty((n_tiles, -(-P // B1_WARP_PIXELS)), dtype=torch.int32, device=dev)
    _launch_fwd(pdata, counts, ts, tw, config, out, tchunk, stop, skipped)
    raster_tiles.launches += 1
    return skipped, stop


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


def raster_bwd_shape(cp: int, ts: int) -> dict:
    """B2's launch shape for cp channels and ts x ts tiles
    (``_kernels.launch_shape``)."""
    return _kernels.launch_shape("raster_bwd_info", cp, ts)


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
