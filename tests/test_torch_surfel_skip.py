"""PyTorch port: the surfel blend's per-row slot skip and stop index, on the CPU.

B6 and B7 (csrc/surfel_fwd.cu) skip the slots that no pixel of a pixel row
can keep (csrc/surfel.cuh ``ms_surfel_row_may_apply``: closed-form bounds
on the filter and the surface branch of the surfel alpha along the row,
with a margin for f32 rounding). Its plain mirror,
``surfel_cuda.surfel_row_may_apply_plain``, is held here to brute force
over every pixel at 64x64 scale:

(a) it never skips a (pixel row, slot) pair that some pixel of the row
    keeps under the per-pixel rule (``_surfel_geometry``'s keep), on
    seeded disks with the card tests' edge cases (failed solves, the s2
    clamp, opacities at the threshold on pixel centres, a tile that stops
    early) and grazing disks, whose plane nearly holds the ray to their
    centre (det A near 0, changing sign along the rows through them), and
    opacities at, just above and below the threshold, 0 and NaN; and it
    does skip most pairs no pixel keeps;
(b) ``surfel_skipped_pairs_plain``, the count of skipped (pixel row, slot)
    pairs the card holds the kernels' count to, against a loop over each
    warp's rows and the 32-slot groups it tests;
(c) ``surfel_stop_plain``, the stop index the kernels write for the
    backward, against a serial f32 walk written in numpy from the Pallas
    kernel's per-pixel rule (mojosplat_tpu/ops/surfel_pallas.py:90-114).

Ortho-primed records (z rows (1, 0, 0)) are held to (a) as well, with
edge-on and nearly edge-on disks. The card holds the kernels' count to the
mirror's, and the skip's output and residual to the full walk's bit for bit
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
from mojosplat_tpu_torch import RenderConfig
from mojosplat_tpu_torch.ops.rasterization import tile_pixel_centers
from mojosplat_tpu_torch.ops.surfel_cuda import (
    _surfel_geometry, surfel_row_may_apply_plain, surfel_skipped_pairs_plain, surfel_stop_plain,
    surfel_warp_rows)
from torch_surfel_cases import grazing_pdata, ortho_pdata, surfel_edge_pdata


def kept_by_row(pdata, n_tiles, ts, tw, config, aux):
    """(n_tiles, ts, cap): whether some pixel of each row keeps the slot
    under the per-pixel rule (brute force over every pixel)."""
    cap = pdata.shape[1] // n_tiles
    pd = pdata.reshape(pdata.shape[0], n_tiles, cap)
    counts = torch.full((n_tiles,), cap, dtype=torch.int32)
    _, _, geo = _surfel_geometry(torch.arange(n_tiles), pd, 0, cap, counts, ts, tw, config, aux)
    return geo["keep"].reshape(n_tiles, ts, ts, cap).any(dim=2)


@pytest.mark.parametrize("ts,aux", [(8, False), (16, True), (32, False)])
def test_row_test_never_skips_a_kept_slot(ts, aux):
    rng = np.random.default_rng(70 + ts)
    tw, cap = 64 // ts, 256
    n_tiles = tw * tw
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=64)
    pdata = torch.from_numpy(grazing_pdata(rng, n_tiles, tw, ts, cap, aux))
    may = surfel_row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    kept = kept_by_row(pdata, n_tiles, ts, tw, cfg, aux)
    assert may.shape == kept.shape == (n_tiles, ts, cap)
    missed = kept & ~may
    assert not bool(missed.any()), f"{int(missed.sum())} kept (row, slot) pairs skipped"
    k = torch.arange(cap).repeat(n_tiles).reshape(n_tiles, cap)
    grazing = (k % 3 == 0)[:, None, :].expand_as(kept)
    assert int((kept & grazing).sum()) > 100  # grazing disks are kept here and there
    assert int((may & ~kept & grazing).sum()) > 0  # and some rows near them stay unsure
    # A NaN opacity may apply.
    op = pdata.reshape(-1, n_tiles, cap)[11]
    nan = torch.isnan(op)[:, None, :].expand_as(may)
    assert bool(may[nan].all())
    # It skips most of what no pixel keeps.
    far = ~kept
    assert float((far & ~may).sum()) >= 0.7 * float(far.sum())


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_row_test_never_skips_a_kept_ortho_slot(ts):
    """The row test was argued for pinhole-primed records; ortho priming
    (z rows (1, 0, 0): A11, A12, A21 constant along the row, r1 affine in
    px) is a case of the same form. Held to brute force on ortho disks with
    edge-on and nearly edge-on ones and threshold opacities, and with some
    walks stopped early: the count of skipped pairs is the mirror's."""
    rng = np.random.default_rng(90 + ts)
    tw, cap = 64 // ts, 256
    n_tiles = tw * tw
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=64)
    pdata = torch.from_numpy(ortho_pdata(rng, n_tiles, tw, ts, cap, False))
    pd = pdata.reshape(-1, n_tiles, cap)
    assert bool((pd[2] == 1).all() and (pd[5] == 0).all() and (pd[8] == 0).all())
    may = surfel_row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    kept = kept_by_row(pdata, n_tiles, ts, tw, cfg, False)
    missed = kept & ~may
    assert not bool(missed.any()), f"{int(missed.sum())} kept (row, slot) pairs skipped"
    k = torch.arange(cap).repeat(n_tiles).reshape(n_tiles, cap)
    graze = ((k % 3 == 0) & (k % 10 != 0))[:, None, :].expand_as(kept)
    assert int((kept & graze).sum()) > 100  # nearly edge-on disks are kept here and there
    nan = torch.isnan(pd[11])[:, None, :].expand_as(may)
    assert bool(may[nan].all())
    far = ~kept
    assert float((far & ~may).sum()) >= 0.7 * float(far.sum())
    # The skip count over walks that stop where the serial walk stops.
    counts = torch.full((n_tiles,), cap, dtype=torch.int32)
    counts[0] = 37
    stop = surfel_stop_plain(pdata, counts, ts, tw, cfg, False)
    assert int(surfel_skipped_pairs_plain(may, counts, stop).sum()) > 0


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_skipped_pairs_plain_counts_each_warps_groups(ts):
    """surfel_skipped_pairs_plain, which the card holds the kernels' skip
    count to, against a loop over warps, 32-slot groups and rows."""
    rng = np.random.default_rng(30 + ts)
    n_tiles, cap, P = 6, 200, ts * ts
    may = torch.from_numpy(rng.random((n_tiles, ts, cap)) < 0.4)
    counts = torch.tensor([0, 1, 31, 33, 200, 260], dtype=torch.int32)
    stop = torch.from_numpy(rng.integers(0, cap + 1, (n_tiles, P)).astype(np.int32))
    stop = torch.minimum(stop, counts.clamp(max=cap)[:, None])
    stop[4, : P // 2] = 40  # half of tile 4's pixels stop in its second group
    got = surfel_skipped_pairs_plain(may, counts, stop)
    rows = surfel_warp_rows(ts)
    assert got.shape == (n_tiles, rows.shape[0]) and got.dtype == torch.int32
    want = np.zeros(tuple(got.shape), np.int64)
    for t in range(n_tiles):
        n = min(int(counts[t]), cap)
        for w in range(rows.shape[0]):
            wstop = int(stop[t, 32 * w : 32 * w + 32].max())
            for k in range(n):
                if k // 32 * 32 <= wstop:
                    want[t, w] += sum(1 for r in range(ts) if rows[w, r] and not may[t, r, k])
    assert np.array_equal(got.numpy(), want)
    assert int(got[0].sum()) == 0 and int(got.sum()) > 0
    # A warp's rows: one of a 32-pixel tile, two of a 16, four of an 8.
    assert int(rows.sum(dim=1).max()) == {32: 1, 16: 2, 8: 4}[ts]
    assert bool((rows.sum(dim=0) >= 1).all())  # every row belongs to a warp


def serial_stop(pdata, counts, ts, tw, config):
    """Each pixel's stop by a serial f32 walk of the surfel rule (numpy; the
    fused differences in f64, rounded once)."""
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // n_tiles
    pd = pdata.reshape(pdata.shape[0], n_tiles, cap)
    px, py = (v.numpy() for v in tile_pixel_centers(torch.arange(n_tiles), ts, tw,
                                                     torch.float32))
    f32, f64 = np.float32, np.float64

    def fms(a, x, b):
        return (f64(a) - x.astype(f64) * f64(b)).astype(f32)

    out = np.empty((n_tiles, ts * ts), np.int32)
    for t in range(n_tiles):
        n = min(int(counts[t]), cap)
        T = np.ones(ts * ts, f32)
        stop = np.full(ts * ts, n, np.int32)
        alive = np.ones(ts * ts, bool)
        for k in range(n):
            qc0, qc1, qc2, a0, a1, a2, b0, b1, b2, c2x, c2y, op = pd[:12, t, k]
            A11, A12, A21, A22 = fms(a0, px[t], a2), fms(b0, px[t], b2), fms(a1, py[t], a2), \
                fms(b1, py[t], b2)
            r1, r2 = -fms(qc0, px[t], qc2), -fms(qc1, py[t], qc2)
            det = A11 * A22 - A12 * A21
            ok = np.abs(det) > f32(1e-9)
            det = np.where(ok, det, f32(1.0))
            u = (r1 * A22 - r2 * A12) / det
            v = (A11 * r2 - A21 * r1) / det
            s2 = np.minimum(u * u + v * v, f32(1e4))
            g_surf = np.where(ok, np.exp(f32(-0.5) * s2), f32(0.0))
            dx, dy = px[t] - c2x, py[t] - c2y
            g_filt = np.exp(-(dx * dx + dy * dy))
            alpha = np.minimum(op * np.maximum(g_surf, g_filt), f32(config.max_alpha))
            keep = alive & (alpha >= f32(config.alpha_threshold))
            nxt = T * (f32(1) - alpha)
            ends = keep & (nxt <= f32(config.transmittance_eps))
            stop[ends] = k
            alive &= ~ends
            T = np.where(keep & ~ends, nxt, T)
        out[t] = stop
    return out


@pytest.mark.parametrize("ts,aux", [(8, True), (16, False)])
def test_stop_plain_matches_a_serial_walk(ts, aux):
    rng = np.random.default_rng(ts + aux)
    n_tiles, tw, cap = 12, 4, 192
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=64, tile_batch=5)
    pdata = torch.from_numpy(surfel_edge_pdata(rng, n_tiles, tw, ts, cap, aux))
    counts = torch.tensor([0, 1, 15, 16, 17, 63, 64, 65, 100, 191, 192, 250],
                          dtype=torch.int32)
    stop = surfel_stop_plain(pdata, counts, ts, tw, cfg, aux)
    assert stop.shape == (n_tiles, ts * ts) and stop.dtype == torch.int32
    want = serial_stop(pdata.numpy(), counts.numpy(), ts, tw, cfg)
    # numpy's exp and the division's operands round apart from torch's on a
    # rare boundary pixel.
    assert (stop.numpy() == want).mean() >= 0.995
    assert int(stop[0].max()) == 0
    assert bool((stop <= counts.clamp(max=cap)[:, None]).all())
    assert int(stop[10].max()) < 64  # tile 10's opaque disks end every walk early
    assert float((stop == counts.clamp(max=cap)[:, None]).float().mean()) > 0.2
