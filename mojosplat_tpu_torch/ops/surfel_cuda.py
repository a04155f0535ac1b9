"""Surfel tile blend forward and backward (kernels B6, B7, B8) and their gather.

Port of ``mojosplat_tpu.ops.surfel_pallas``. Field packing, field-major
(rows, n_tiles * cap), 16 rows or 18 with the maps:

    0-2   qc0', qc1', qc2      qc0' = fx qc0 + cx qc2 (y likewise)
    3-5   a0',  a1',  a2       a0' = fx a0 + cx a2, a1' = fy a1 + cy a2
    6-8   b0',  b1',  b2
    9-10  c2x,  c2y            the projected centre (pixels)
    11    opacity
    12-14 rgb
    15    zero pad             (with the maps: 15-17 camera-frame normals)

The primes fold the intrinsics into the rows (scaling the 2x2 system's
rows by fx and fy leaves its solution unchanged), so the kernels see only
pixel coordinates. Per (pixel, slot):

    A11 = a0' - px a2   A12 = b0' - px b2   r1 = px qc2 - qc0'
    A21 = a1' - py a2   A22 = b1' - py b2   r2 = py qc2 - qc1'
    (u, v) = A^-1 r where |det A| > 1e-9;  g_surf = exp(-min(u^2 + v^2, 1e4) / 2)
    g_filt = exp(-((px - c2x)^2 + (py - c2y)^2) / (2 * 0.5))
    alpha  = min(opacity * max(g_surf, g_filt), max_alpha), kept iff >= threshold

and the front-to-back rule of the 3DGS blend. With the maps the blend also
accumulates the intersection-depth moments m1 = sum(w z), m2 = sum(w z^2),
z = qc2 + u a2 + v b2 (qc2 where the filter wins or the solve fails).

  - ``gather_surfel_tile_data`` stacks the primed columns and gathers the
    slot table with one ``index_select``; its adjoint is the 3DGS gather's
    (``raster_cuda.gather_slots``: stable sort + segment sum B3).
  - ``raster_surfel_tiles`` blends: (n_tiles, 5, ts * ts) channel-major,
    rgb, the blended pad row, T; with the maps (n_tiles, 9, ts * ts), rgb,
    normals, m1, m2, T. Differentiable with respect to ``pdata``: the
    forward is B6 or B7 (``csrc/surfel_fwd.cu``), which then also writes
    the backward's residual, and the backward is B8 (``csrc/surfel_bwd.cu``).

On CPU tensors the wrappers run the plain versions, which port the Pallas
kernels' math (``_surfel_chunk_geometry``, ``_fwd_kernel``,
``_bwd_kernel``) over chunks of ``chunk_size`` slots. On a CUDA tensor a
wrapper launches its kernel or raises. B6/B7 skip the slots no pixel of a
warp's rows can keep; ``surfel_row_may_apply_plain`` mirrors that row
test, ``surfel_skipped_pairs_plain`` its count and ``surfel_stop_plain``
the stop index the kernels write, and ``raster_surfel_tiles_check`` runs
the kernels with the count, or with the test off (the full walk).
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..camera import Camera
from ..config import RenderConfig
from .raster_cuda import RESID_CHUNK, check_tiles, gather_slots
from .rasterization import _blend_chunk, _chunk_transmittance, tile_pixel_centers

_SROWS, _AUX_ROWS = 16, 18
_FILTER_SIGMA2 = 0.5  # as surfel._FILTER_SIGMA2
_DET_EPS = 1e-9
_S2_MAX = 1e4


def primed_surfel_columns(columns, camera: Camera) -> tuple:
    """Fold the intrinsics into the 12 surfel columns of
    ``surfel.surfel_alpha_columns`` (see the module docstring).

    For an ortho camera the parallel-ray system ``u a_x + v b_x = xn -
    qc_x`` takes the same kernel form with the z rows (qc2, a2, b2) = (1,
    0, 0): A11 = fx a_x and r1 = px - (fx qc_x + cx) = fx (xn - qc_x), the
    same row scaling by fx (and fy). The maps' intersection depth reads
    those z rows, so the kernels take ortho only without the maps."""
    (qcx, qcy, qcz, ax, ay, az, bx, by, bz, c2x, c2y, op) = columns

    if camera.camera_model == "ortho":
        one, zero = torch.ones_like(qcz), torch.zeros_like(qcz)
        return (camera.fx * qcx + camera.cx, camera.fy * qcy + camera.cy, one,
                camera.fx * ax, camera.fy * ay, zero,
                camera.fx * bx, camera.fy * by, zero,
                c2x, c2y, op)

    def prime(x, y, z):
        return camera.fx * x + camera.cx * z, camera.fy * y + camera.cy * z, z

    return (*prime(qcx, qcy, qcz), *prime(ax, ay, az), *prime(bx, by, bz), c2x, c2y, op)


def slab_primed_columns(pcols, row0) -> list:
    """The 12 primed columns for a slab whose first image row is ``row0``:
    the kernels see slab-row pixels, ``py = py_image - row0``, so the y
    rows take the shift (A21 = a1' - py_image a2 = (a1' - row0 a2) - py
    a2, and so for qc1' and b1') and the filter centre c2y moves with it.
    The reference's own expressions, so both packages pack the same
    records."""
    out = list(pcols)
    out[1] = pcols[1] - row0 * pcols[2]  # qc1'
    out[4] = pcols[4] - row0 * pcols[5]  # a1'
    out[7] = pcols[7] - row0 * pcols[8]  # b1'
    out[10] = pcols[10] - row0  # c2y
    return out


def gather_surfel_tile_data(columns, slot_gids, counts) -> torch.Tensor:
    """(16 or 18, n_slots) f32 packed rows of the (N,) ``columns`` [primed
    qc(3), a(3), b(3), c2(2), opacity, rgb(3), and normals(3) with the
    maps] for the slot table ``slot_gids`` of tiles with ``counts``; a
    16th zero row pads the columns without the maps."""
    nconst = len(columns)
    N = columns[0].shape[0]
    cols = [c.to(torch.float32) for c in columns]
    cols += [torch.zeros((N,), dtype=torch.float32, device=cols[0].device)] * (_SROWS - nconst)
    return gather_slots(torch.stack(cols, dim=0), slot_gids, counts, nconst)


def _fms(a, x, b):
    """a - x * b with the product kept exact (in f64), as the kernels'
    fused multiply-add computes it: the primed differences cancel where
    the pixel is far from the principal point, and the reference's
    compiler fuses them too."""
    return (a.double() - x.double() * b.double()).float()


def _surfel_geometry(tiles, pd, k0, K, counts, ts, tw, config, aux):
    """Chunk k0 of the given tiles: its slot rows (rows, G, K), the alphas
    (G, P, K) zeroed where skipped, and the terms the backward reads (the
    Pallas kernels' ``_surfel_chunk_geometry``)."""
    px, py = tile_pixel_centers(tiles, ts, tw, torch.float32)
    px, py = px[..., None], py[..., None]  # (G, P, 1)
    chunk = pd[:, tiles, k0 : k0 + K]  # (rows, G, K)
    lane = torch.arange(chunk.shape[-1], device=pd.device)
    valid = (k0 + lane)[None, :] < counts[tiles, None]  # (G, K)
    qc0, qc1, qc2, a0, a1, a2, b0, b1, b2, c2x, c2y, op = (
        chunk[r][:, None, :] for r in range(12))  # each (G, 1, K)

    A11 = _fms(a0, px, a2)  # (G, P, K)
    A12 = _fms(b0, px, b2)
    A21 = _fms(a1, py, a2)
    A22 = _fms(b1, py, b2)
    r1 = -_fms(qc0, px, qc2)
    r2 = -_fms(qc1, py, qc2)
    det = A11 * A22 - A12 * A21
    ok = torch.abs(det) > _DET_EPS
    det_safe = torch.where(ok, det, torch.ones_like(det))
    u = (r1 * A22 - r2 * A12) / det_safe
    v = (A11 * r2 - A21 * r1) / det_safe
    s2 = torch.clamp(u * u + v * v, max=_S2_MAX)
    g_surf = torch.where(ok, torch.exp(-0.5 * s2), torch.zeros_like(s2))
    dx = px - c2x
    dy = py - c2y
    g_filt = torch.exp(-(dx * dx + dy * dy) / (2.0 * _FILTER_SIGMA2))
    gm = torch.maximum(g_surf, g_filt)
    raw = op * gm
    alpha = torch.clamp(raw, max=config.max_alpha)
    keep = (alpha >= config.alpha_threshold) & valid[:, None, :]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    geo = dict(A11=A11, A12=A12, A21=A21, A22=A22, det=det_safe, ok=ok, u=u, v=v, s2=s2,
               g_surf=g_surf, g_filt=g_filt, gm=gm, dx=dx, dy=dy, op=op, raw=raw, keep=keep,
               px=px, py=py, a2=a2, b2=b2)
    if aux:
        geo["use_surf"] = ok & (g_surf >= g_filt)
        geo["z"] = torch.where(geo["use_surf"], qc2 + u * a2 + v * b2, qc2)
    return chunk, alpha, geo


def _layout(pdata, counts, aux):
    """(rows, n_tiles, cap, ncc, oc): ncc constant channels are blended
    (rgb + pad, or rgb + normals), oc output rows."""
    rows = pdata.shape[0]
    if rows != (_AUX_ROWS if aux else _SROWS):
        raise ValueError(f"aux={aux} takes {_AUX_ROWS if aux else _SROWS} pdata rows, got {rows}")
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    return rows, n_tiles, cap, rows - 12, 9 if aux else 5


def raster_surfel_tiles_plain(pdata, counts, ts: int, tw: int, config: RenderConfig,
                              aux: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the surfel blend forward (B6, or B7 with
    ``aux``): the chunked-cumprod recurrence of the 3DGS plain blend over
    ``tile_batch`` tiles at a time."""
    rows, n_tiles, cap, ncc, oc = _layout(pdata, counts, aux)
    P, K = ts * ts, config.chunk_size
    dev = pdata.device
    pd = pdata.reshape(rows, n_tiles, cap)
    out = torch.empty((n_tiles, oc, P), dtype=torch.float32, device=dev)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=dev)
        done = torch.zeros((G, P), dtype=torch.bool, device=dev)
        acc = torch.zeros((G, P, ncc), dtype=torch.float32, device=dev)
        acc_v = torch.zeros((G, P, 2 if aux else 0), dtype=torch.float32, device=dev)
        for k0 in range(0, cap, K):
            chunk, alpha, geo = _surfel_geometry(tiles, pd, k0, K, counts, ts, tw, config, aux)
            cols = chunk[12:].permute(1, 2, 0)  # (G, K, ncc)
            if aux:
                z = geo["z"]
                T, done, acc, acc_v = _blend_chunk(T, done, acc, alpha, cols,
                                                   config.transmittance_eps,
                                                   torch.stack([z, z * z], dim=-1), acc_v)
            else:
                T, done, acc = _blend_chunk(T, done, acc, alpha, cols,
                                            config.transmittance_eps)
        out[g0 : g0 + G] = torch.cat([acc, acc_v, T[..., None]], dim=-1).transpose(1, 2)
    return out


def raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts: int, tw: int,
                                  config: RenderConfig, aux: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the surfel blend backward (B8): d pdata
    (rows, n_tiles * cap) from the output cotangent ``gout`` (n_tiles, oc,
    ts * ts).

    The Pallas ``_bwd_kernel`` written out over groups of ``tile_batch``
    tiles: a forward walk records each chunk's incoming transmittance and
    done latch; the chunks are then walked in reverse carrying the
    transmittance cotangent, with ``d_eff = cv T_before - (S + gT T_out) /
    (1 - eff)``, then the hand-derived adjoint of the surfel response:
    the low-pass branch to the centre, the 2x2 solve (``d_r = A^-T d_q``,
    ``d_A = -d_r q^T``) and, with the maps, the intersection depth z.
    """
    rows, n_tiles, cap, ncc, oc = _layout(pdata, counts, aux)
    P, K = ts * ts, config.chunk_size
    eps = config.transmittance_eps
    dev = pdata.device
    pd = pdata.reshape(rows, n_tiles, cap)
    d_pd = torch.zeros((rows, n_tiles, cap), dtype=torch.float32, device=dev)
    group = config.tile_batch or max(n_tiles, 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=dev)
        done = torch.zeros((G, P), dtype=torch.bool, device=dev)
        history = []
        for k0 in range(0, cap, K):
            history.append((T, done))
            _, alpha, _ = _surfel_geometry(tiles, pd, k0, K, counts, ts, tw, config, aux)
            *_, trans, done = _chunk_transmittance(T, done, alpha, eps)
            T = T * trans

        g = gout[g0 : g0 + G]
        v_cot = g[:, :ncc, :].transpose(1, 2)  # (G, P, ncc)
        if aux:
            v_z, v_z2 = g[:, 6, :, None], g[:, 7, :, None]  # (G, P, 1)
        gt = g[:, oc - 1, :]  # (G, P)
        for i in reversed(range(len(history))):
            k0 = i * K
            t_in, done_in = history[i]
            chunk, alpha, geo = _surfel_geometry(tiles, pd, k0, K, counts, ts, tw, config, aux)
            applied, eff, excl, trans, _ = _chunk_transmittance(t_in, done_in, alpha, eps)
            ome = 1.0 - eff
            t_before = t_in[..., None] * excl
            w = eff * t_before
            t_out = t_in * trans

            cols = chunk[12:].permute(1, 2, 0)  # (G, K, ncc)
            cv = torch.matmul(v_cot, cols.transpose(1, 2))  # (G, P, K)
            if aux:
                z = geo["z"]
                cv = cv + v_z * z + v_z2 * z * z
            d_cols = torch.matmul(w.transpose(1, 2), v_cot)  # (G, K, ncc)
            q = w * cv
            rev = torch.cumsum(q.flip(-1), dim=-1).flip(-1)
            S = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], dim=-1)
            d_eff = cv * t_before - (S + (gt * t_out)[..., None]) / ome
            d_alpha = torch.where(applied, d_eff, zero)
            d_raw = torch.where(geo["keep"] & (geo["raw"] < config.max_alpha), d_alpha, zero)

            d_op = d_raw * geo["gm"]
            d_gm = d_raw * geo["op"]
            surf_sel = geo["g_surf"] >= geo["g_filt"]
            d_gsurf = torch.where(surf_sel, d_gm, zero)
            d_gfilt = torch.where(surf_sel, zero, d_gm)
            # The low-pass branch -> the projected centre.
            gf = d_gfilt * geo["g_filt"] / _FILTER_SIGMA2
            d_c2x = gf * geo["dx"]
            d_c2y = gf * geo["dy"]
            # The surface branch -> the 2x2 solve.
            d_s2 = torch.where(geo["ok"] & (geo["s2"] < _S2_MAX),
                               -0.5 * d_gsurf * geo["g_surf"], zero)
            u, v = geo["u"], geo["v"]
            d_u = d_s2 * 2.0 * u
            d_v = d_s2 * 2.0 * v
            if aux:
                # z = qc2 + u a2 + v b2 on the surface branch, qc2 otherwise.
                d_z = w * (v_z + 2.0 * z * v_z2)
                d_zs = torch.where(geo["use_surf"], d_z, zero)
                d_u = d_u + d_zs * geo["a2"]
                d_v = d_v + d_zs * geo["b2"]
            det = geo["det"]
            d_r1 = (geo["A22"] * d_u - geo["A21"] * d_v) / det
            d_r2 = (-geo["A12"] * d_u + geo["A11"] * d_v) / det
            d_A11 = -d_r1 * u
            d_A12 = -d_r1 * v
            d_A21 = -d_r2 * u
            d_A22 = -d_r2 * v
            px, py = geo["px"], geo["py"]
            d_qc2 = px * d_r1 + py * d_r2
            d_a2 = -px * d_A11 - py * d_A21
            d_b2 = -px * d_A12 - py * d_A22
            if aux:
                d_qc2 = d_qc2 + d_z
                d_a2 = d_a2 + d_zs * u
                d_b2 = d_b2 + d_zs * v
            d_geo = torch.stack([-d_r1, -d_r2, d_qc2, d_A11, d_A21, d_a2, d_A12, d_A22, d_b2,
                                 d_c2x, d_c2y, d_op]).sum(dim=2)  # (12, G, K)
            d_pd[:12, g0 : g0 + G, k0 : k0 + K] = d_geo
            d_pd[12:, g0 : g0 + G, k0 : k0 + K] = d_cols.permute(2, 0, 1)
            gt = torch.sum(eff * excl * cv, dim=-1) + gt * trans
    return d_pd.reshape(rows, n_tiles * cap)


def surfel_fwd_warps(ts: int) -> int:
    """Warps of a ts x ts tile in B6/B7 (``csrc/surfel_fwd.cu``): a thread
    a pixel in blocks of up to 256 (whole warps), so warp w owns pixels
    [32 w, 32 w + 32) of the tile."""
    P = ts * ts
    return -(-P // 256) * ((min(P, 256) + 31) // 32)


def surfel_warp_rows(ts: int) -> torch.Tensor:
    """(warps, ts) bool: the pixel rows each B6/B7 warp tests, those of its
    pixels, taken whole (none for a warp past the tile)."""
    w = torch.arange(surfel_fwd_warps(ts))
    first = 32 * w // ts
    last = torch.clamp((32 * w + 31) // ts, max=ts - 1)
    r = torch.arange(ts)
    return (r[None, :] >= first[:, None]) & (r[None, :] <= last[:, None])


def surfel_row_may_apply_plain(pdata, n_tiles: int, ts: int, tw: int,
                               config: RenderConfig) -> torch.Tensor:
    """(n_tiles, ts, cap) bool: whether some pixel of each pixel row of a
    tile may keep slot k; False only where none can.

    The plain mirror of ``ms_surfel_row_may_apply`` (``csrc/surfel.cuh``),
    each f32 operation in the same order: lam = ln(opacity / threshold)
    raised by 1e-5 (|lam| + |ln threshold| + 1); no pixel keeps a slot with
    lam < 0; the filter branch is out where the row's least dx^2 + dy^2
    exceeds lam; the surface branch where phi = |N|^2 - 2 lam det^2 (N, det
    the 2x2 solve's numerators and determinant, affine along the row,
    interpolated between the end pixels') exceeds 2e-5 (M_N + s M_det) B
    at both ends and at its vertex, s = sqrt(2 lam), M the products'
    magnitudes and B the largest |N| + s |det| at the ends. NaN anywhere
    and a threshold <= 0 may apply.
    """
    rows = pdata.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    dev, f32 = pdata.device, torch.float32
    pd = pdata.reshape(rows, n_tiles, cap)
    log_thr = torch.log(torch.tensor(config.alpha_threshold, dtype=f32, device=dev))
    r = torch.arange(ts, device=dev)
    out = torch.empty((n_tiles, ts, cap), dtype=torch.bool, device=dev)
    group = 64  # tiles at a time: (group, ts, cap) intermediates
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        ty, tx = tiles // tw, tiles % tw
        ends = [((tx * ts + e * (ts - 1)).to(f32) + 0.5)[:, None, None] for e in (0, 1)]
        py = ((ty[:, None] * ts + r[None, :]).to(f32) + 0.5)[..., None]  # (G, ts, 1)
        qc0, qc1, qc2, a0, a1, a2, b0, b1, b2, c2x, c2y, op = (
            pd[k, tiles][:, None, :] for k in range(12))  # each (G, 1, cap)
        l0 = torch.log(op) - log_thr
        lam = l0 + 1e-5 * ((l0.abs() + log_thr.abs()) + 1.0)
        # The filter's least exponent over the row.
        dy = py - c2y
        lo, hi = ends[0] - c2x, ends[1] - c2x
        mdx = torch.where(lo > 0, lo, torch.where(hi < 0, -hi, torch.zeros_like(hi)))
        filt_out = (mdx * mdx + dy * dy) * (1.0 - 1e-5) > lam
        # The surface: N and det at the end pixels.
        A21, A22, r2 = _fms(a1, py, a2), _fms(b1, py, b2), -_fms(qc1, py, qc2)
        nu, nv, det = [], [], []
        md = mn = torch.zeros((), dtype=f32, device=dev)
        for x in ends:
            A11, A12, r1 = _fms(a0, x, a2), _fms(b0, x, b2), -_fms(qc0, x, qc2)
            p11, p12 = A11 * A22, A12 * A21
            pu1, pu2, pv1, pv2 = r1 * A22, r2 * A12, A11 * r2, A21 * r1
            det.append(p11 - p12)
            nu.append(pu1 - pu2)
            nv.append(pv1 - pv2)
            md = torch.fmax(md, p11.abs() + p12.abs())
            mn = torch.fmax(mn, (pu1.abs() + pu2.abs()) + (pv1.abs() + pv2.abs()))
        s2 = 2.0 * lam
        s = torch.sqrt(s2)
        phi, b = [], torch.zeros((), dtype=f32, device=dev)
        for e in (0, 1):
            n2 = nu[e] * nu[e] + nv[e] * nv[e]
            phi.append(n2 - s2 * (det[e] * det[e]))
            b = torch.fmax(b, torch.sqrt(n2) + s * det[e].abs())
        margin = (2e-5 * (mn + s * md)) * b
        du, dv, dd = nu[1] - nu[0], nv[1] - nv[0], det[1] - det[0]
        qa = (du * du + dv * dv) - s2 * (dd * dd)
        qb = (nu[0] * du + nv[0] * dv) - s2 * (det[0] * dd)
        inside = (qa > 0) & (-qb > 0) & (-qb < qa)
        vertex_out = torch.where(inside, (phi[0] - (qb * qb) / qa) > margin,
                                 (qa == qa) & (qb == qb))
        surf_out = (phi[0] > margin) & (phi[1] > margin) & vertex_out
        out[g0 : g0 + tiles.shape[0]] = ~(lam < 0) & (~(lam < 1e30) | ~filt_out | ~surf_out)
    return out


def surfel_skipped_pairs_plain(may, counts, stop) -> torch.Tensor:
    """(n_tiles, warps) int32: B6/B7's count of the (pixel row, slot) pairs
    its row test skipped, from ``surfel_row_may_apply_plain``'s ``may``
    (n_tiles, ts, cap) and the kernel's ``stop`` (n_tiles, ts * ts). A warp
    tests the slots below the count in groups of 32, each against every
    row of the warp (``surfel_warp_rows``), unless all its pixels stopped
    before the group."""
    n_tiles, ts, cap = may.shape
    dev = may.device
    pw = (torch.arange(ts * ts, device=dev) // 32)  # each pixel's warp
    nw = surfel_fwd_warps(ts)
    wstop = torch.full((n_tiles, nw), -1, dtype=torch.int64, device=dev)
    wstop = wstop.scatter_reduce(1, pw.expand(n_tiles, -1), stop.to(torch.int64), "amax")
    slot = torch.arange(cap, device=dev)
    live = slot[None, :] < counts.clamp(0, cap)[:, None].to(torch.int64)  # (n_tiles, cap)
    tested = live[:, None, :] & ((slot // 32 * 32)[None, None, :] <= wstop[..., None])
    # Rows a warp tests that skip each slot: small integers, exact in f32.
    per_warp = torch.einsum("wr,trk->twk", surfel_warp_rows(ts).to(dev, torch.float32),
                            (~may).to(torch.float32)).to(torch.int64)
    return (per_warp * tested).sum(dim=2).to(torch.int32)


def surfel_stop_plain(pdata, counts, ts: int, tw: int, config: RenderConfig,
                      aux: bool = False) -> torch.Tensor:
    """Plain version of B6's and B7's ``stop`` residual: (n_tiles, ts * ts)
    int32, each pixel's first slot whose transmittance test ends its walk,
    or the tile's count (clamped to cap). A serial f32 walk over the slots,
    the kernels' own: T *= 1 - alpha at each kept slot."""
    rows, n_tiles, cap, _, _ = _layout(pdata, counts, aux)
    P, K, eps = ts * ts, config.chunk_size, config.transmittance_eps
    dev = pdata.device
    pd = pdata.reshape(rows, n_tiles, cap)
    out = torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        G = tiles.shape[0]
        T = torch.ones((G, P), dtype=torch.float32, device=dev)
        alive = torch.ones((G, P), dtype=torch.bool, device=dev)
        stop = counts[tiles].clamp(0, cap).to(torch.int32)[:, None].expand(G, P).clone()
        for k0 in range(0, cap, K):
            _, alpha, geo = _surfel_geometry(tiles, pd, k0, K, counts, ts, tw, config, aux)
            for j in range(alpha.shape[-1]):
                keep = geo["keep"][..., j] & alive
                nxt = T * (1.0 - alpha[..., j])
                ends = keep & (nxt <= eps)
                stop[ends] = k0 + j
                alive &= ~ends
                T = torch.where(keep & ~ends, nxt, T)
        out[g0 : g0 + G] = stop
    return out


def raster_surfel_tiles_check(pdata, counts, ts: int, tw: int, config: RenderConfig,
                              aux: bool, walk_all: bool = False):
    """(out, tchunk, stop, skipped): B6 (B7 with ``aux``) with its residual
    and each warp's count of the (pixel row, slot) pairs its row test
    skipped, (n_tiles, ``surfel_fwd_warps(ts)``) int32; with ``walk_all``
    the row test is off (the full walk, every count 0), to hold the skip's
    output and residual to it bit for bit. The check of a kernel, so CUDA
    tensors only (``surfel_row_may_apply_plain``,
    ``surfel_skipped_pairs_plain`` and ``surfel_stop_plain`` are its plain
    counterparts). Counts a launch as ``raster_surfel_tiles_fwd`` does."""
    if pdata.device.type != "cuda":
        raise ValueError("raster_surfel_tiles_check runs the kernel: pass CUDA tensors")
    n_tiles = counts.shape[0]
    cap = _check_surfel_args(pdata, counts, ts, aux)
    rows, P, dev = pdata.shape[0], ts * ts, pdata.device
    out = torch.empty((n_tiles, 9 if aux else 5, P), dtype=torch.float32, device=dev)
    tchunk = torch.empty((n_tiles, -(-cap // RESID_CHUNK), P), dtype=torch.float32, device=dev)
    stop = torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
    skipped = torch.zeros((n_tiles, surfel_fwd_warps(ts)), dtype=torch.int32, device=dev)
    _kernels.launch(
        "surfel_fwd_check_launch", dev, int(walk_all), pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        config.transmittance_eps, out.data_ptr(), tchunk.data_ptr(), stop.data_ptr(),
        skipped.data_ptr(),
    )
    if aux:
        raster_surfel_tiles_fwd.launches_maps += 1
    else:
        raster_surfel_tiles_fwd.launches += 1
    return out, tchunk, stop, skipped


def _check_surfel_args(pdata, counts, ts: int, aux: bool) -> int:
    cap = check_tiles(pdata, counts, ts)
    _layout(pdata, counts, aux)
    return cap


def raster_surfel_tiles_fwd(pdata, counts, ts: int, tw: int, config: RenderConfig,
                            aux: bool, residual: bool):
    """(out, residual): B6 (B7 with ``aux``) on a CUDA tensor, the plain
    version on a CPU tensor (whose residual is None). The residual, written
    only when asked for, is (tchunk, stop) as B1 writes it. Counts a launch
    of B6 in ``raster_surfel_tiles_fwd.launches``, of B7 in
    ``raster_surfel_tiles_fwd.launches_maps``, and a written residual in
    ``raster_surfel_tiles_fwd.residuals``."""
    if pdata.device.type == "cpu":
        return raster_surfel_tiles_plain(pdata, counts, ts, tw, config, aux), None
    cap = _check_surfel_args(pdata, counts, ts, aux)
    rows, n_tiles, P = pdata.shape[0], counts.shape[0], ts * ts
    out = torch.empty((n_tiles, 9 if aux else 5, P), dtype=torch.float32, device=pdata.device)
    resid = None
    if residual:
        raster_surfel_tiles_fwd.residuals += 1
        resid = (
            torch.empty((n_tiles, -(-cap // RESID_CHUNK), P), dtype=torch.float32,
                        device=pdata.device),
            torch.empty((n_tiles, P), dtype=torch.int32, device=pdata.device),
        )
    _kernels.launch(
        "surfel_fwd_launch", pdata.device, pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        config.transmittance_eps, out.data_ptr(),
        resid[0].data_ptr() if resid else None, resid[1].data_ptr() if resid else None,
    )
    if aux:
        raster_surfel_tiles_fwd.launches_maps += 1
    else:
        raster_surfel_tiles_fwd.launches += 1
    return out, resid


def raster_surfel_tiles_bwd(pdata, counts, gout, residual, ts: int, tw: int,
                            config: RenderConfig, aux: bool) -> torch.Tensor:
    """d pdata of the surfel blend: B8 on CUDA tensors, given the forward
    kernel's residual; ``raster_surfel_tiles_bwd_plain`` on CPU tensors
    (residual None). Counts a launch in ``raster_surfel_tiles_bwd.launches``."""
    if pdata.device.type == "cpu":
        return raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, config, aux)
    cap = _check_surfel_args(pdata, counts, ts, aux)
    rows, n_tiles, P = pdata.shape[0], counts.shape[0], ts * ts
    gout = gout.contiguous()
    _kernels.require(gout, "gout", torch.float32, 3)
    oc = 9 if aux else 5
    if tuple(gout.shape) != (n_tiles, oc, P):
        raise ValueError(f"gout must be {(n_tiles, oc, P)}, got {tuple(gout.shape)}")
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
        "surfel_bwd_launch", pdata.device, pdata.data_ptr(), rows, n_tiles, cap,
        counts.data_ptr(), ts, tw, config.alpha_threshold, config.max_alpha,
        gout.data_ptr(), tchunk.data_ptr(), stop.data_ptr(), d_pdata.data_ptr(),
    )
    raster_surfel_tiles_bwd.launches += 1
    return d_pdata


def surfel_fwd_shape(aux: bool, ts: int, residual: bool) -> dict:
    """B6's (B7's with ``aux``) launch shape for ts x ts tiles, the
    instantiation without or with the ``residual`` (``_kernels.launch_shape``;
    no clusters)."""
    return _kernels.launch_shape("surfel_fwd_info", int(aux), int(residual), ts)


def surfel_bwd_shape(aux: bool, ts: int) -> dict:
    """B8's launch shape without or with the maps (``aux``) for ts x ts
    tiles (``_kernels.launch_shape``)."""
    return _kernels.launch_shape("surfel_bwd_info", int(aux), ts)


class _RasterSurfelTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pdata, counts, ts, tw, config, aux):
        out, resid = raster_surfel_tiles_fwd(pdata, counts, ts, tw, config, aux, residual=True)
        ctx.save_for_backward(pdata, counts, *(resid or ()))
        ctx.args = (ts, tw, config, aux)
        return out

    @staticmethod
    def backward(ctx, gout):
        pdata, counts, *resid = ctx.saved_tensors
        d_pdata = raster_surfel_tiles_bwd(pdata, counts, gout, tuple(resid) or None, *ctx.args)
        return d_pdata, None, None, None, None, None


def raster_surfel_tiles(pdata, counts, ts: int, tw: int, config: RenderConfig,
                        aux: bool = False) -> torch.Tensor:
    """Blend each tile's surfel slots: (n_tiles, 5, ts * ts), or (n_tiles,
    9, ts * ts) with ``aux`` (the maps). Differentiable with respect to
    ``pdata``; when no gradient is needed the forward kernel writes no
    residual."""
    if torch.is_grad_enabled() and pdata.requires_grad:
        return _RasterSurfelTiles.apply(pdata, counts, ts, tw, config, aux)
    return raster_surfel_tiles_fwd(pdata, counts, ts, tw, config, aux, residual=False)[0]


raster_surfel_tiles_fwd.launches = 0
raster_surfel_tiles_fwd.launches_maps = 0
raster_surfel_tiles_fwd.residuals = 0
raster_surfel_tiles_bwd.launches = 0
