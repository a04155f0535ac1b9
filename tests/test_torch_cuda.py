"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
mojosplat_tpu_torch/csrc/ at first use) and skip elsewhere. They import no
jax and need no conftest, so on a machine without jax run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

B4 and B5 must equal their plain versions exactly; B1 must agree within
1e-5 on all but 0.01% of values and within 5e-3 everywhere (a sequential
f32 product against a chunked cumprod can flip a boundary slot). B2, whose
per-slot gradients sum over a tile's pixels, is held per gradient row r
with scale_r = max |plain_r|: within 1e-4 scale_r on all but 0.001% of
values and within 1e-3 scale_r everywhere (the f32 sums over pixels run in
other orders; a flip would move one pixel's share of a slot's sum). B3 is
bit-equal to index_add_ on CPU copies of its inputs (both add each segment
in row order from 0), also with perm, into a larger buffer's rows, with
windows of many rows, long segments at a window boundary, empty windows
and no live key, at 1, 9 and 18 fields (one, three and six field groups); it runs in 256-thread
blocks with no local memory; the packed and surfel gathers' gradients
equal the CPU's bit for bit and each other across runs. B5 is exact at
caps 1 to 4096, on NaN payloads compared as words. The surfel blend B6/B7 is held to B1's
rule and its backward B8 to B2's, and B8 is bitwise equal to itself, also
on edge slots (failed solves, the s2 clamp, opacities at the threshold,
unapplied chunks, early stops) and runs in clusters of 4 blocks with no
local memory; there, and on grazing disks, B6/B7 also give the serial
walk's stops (all but 0.1%) and the same output with and without the
residual, their row skip's output and residual equal the full walk's bit
for bit and its count of skipped (row, slot) pairs the plain mirror's, in
blocks of at most 256 threads, 32 warps an SM, with no local memory. B4 is
held on every capacity column.
The probe's variants (B9) are held to B1's rule, blend1 and blend3 with a
share of 0.5% (a weight's bf16 rounding turns an f32 ulp into 2^-8 of the
product), blend and memonly within 1e-6 of the row's scale; its full
variant is bit-equal to B1. B1's count of the (warp, slot) pairs its
row test skipped equals the plain mirror's count from B1's own stop
indices, and its output and residual are the same with the count
written; B2 runs in clusters of 4 blocks of 256 threads with no spill.
With tight_cull, the "cuda" route bins
exactly as the "torch" route (ids and counters) and renders by B1's rule;
the absgrad and view-space sinks' gradients of the two routes agree by
B2's rule. The benchmark CLI's run_pipeline bins as many intersections on
both routes, and a view of the capture maker's scene renders by B1's rule.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mojosplat_tpu_torch import (
    Camera, RenderConfig, apply_pose_delta, render_gaussians, render_surfels)
from mojosplat_tpu_torch.ops.expand_cuda import (
    segment_expand_offsets, segment_expand_offsets_plain)
from mojosplat_tpu_torch.ops.raster_cuda import (
    gather_tile_data, raster_bwd_shape, raster_tiles, raster_tiles_bwd_plain,
    raster_tiles_fwd, raster_tiles_plain, raster_tiles_skips, row_may_apply_plain,
    skipped_pairs_plain)
from mojosplat_tpu_torch.ops.raster_probe import VARIANTS, raster_variant, raster_variant_plain
from mojosplat_tpu_torch.ops.segsum_cuda import (
    segment_sum_cols, segment_sum_cols_plain, segsum_shape)
from mojosplat_tpu_torch.ops.slice_cuda import (
    segment_slice_gather, segment_slice_gather_plain)
from mojosplat_tpu_torch.ops.surfel_cuda import (
    gather_surfel_tile_data, raster_surfel_tiles, raster_surfel_tiles_bwd_plain,
    raster_surfel_tiles_check, raster_surfel_tiles_fwd, raster_surfel_tiles_plain,
    surfel_bwd_shape, surfel_fwd_shape, surfel_row_may_apply_plain, surfel_skipped_pairs_plain,
    surfel_stop_plain)
from mojosplat_tpu_torch.surfel import bin_surfels, pack_surfel_tiles
from torch_surfel_cases import grazing_pdata, ortho_pdata, surfel_edge_pdata, surfel_pdata

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _expand_fields(rng, counts):
    """(5, N) int32 fields: the exclusive prefix sum of ``counts``, then four
    rows of random payload."""
    offsets = np.cumsum(counts) - counts
    rows = [offsets] + [rng.integers(-5, 1 << 30, counts.size) for _ in range(4)]
    return np.stack(rows).astype(np.int32).reshape(5, counts.size)


def test_expand_kernel_exact(dev):
    rng = np.random.default_rng(0)
    n = 5000
    counts = rng.integers(0, 12, n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0
    counts[-100:] = 0
    # The binning path's order: the zero-count gaussians last.
    presorted = np.concatenate([counts[counts > 0], np.zeros(1000, np.int32)])
    # A run of zero-count gaussians longer than a block's owner staging buffer
    # (2048 offsets), between two runs of counts; and one gaussian alone.
    gap = np.concatenate([rng.integers(1, 12, 3000), np.zeros(6000, np.int64),
                          rng.integers(1, 12, 3000)]).astype(np.int32)
    block = 2048  # slots a block of the kernel writes
    for cts in (counts, presorted, gap, np.array([7], np.int32), np.zeros(0, np.int32)):
        fields = torch.from_numpy(_expand_fields(rng, cts)).to(dev)
        total = int(cts.sum())
        # On and off block boundaries, total below, at and above the capacity.
        for capacity in sorted({1, 7, block - 1, block, block + 1, 3 * block, max(total, 1),
                                total // 2 + 1, total + 1, total + 999,
                                (total // block + 2) * block}):
            got = segment_expand_offsets(fields, capacity)
            assert torch.equal(got, segment_expand_offsets_plain(fields, capacity)), (
                cts.size, total, capacity)
    with pytest.raises(ValueError):
        segment_expand_offsets(fields.float(), 10)


def test_slice_kernel_exact(dev):
    rng = np.random.default_rng(1)
    M = 10_000
    for dtype in (torch.int32, torch.float32):
        src = torch.from_numpy(rng.integers(-9, 9999, M)).to(dev, dtype)
        starts = torch.tensor([-5, 0, 1, 127, 4000, M - 3, M, M + 50], dtype=torch.int32,
                              device=dev)
        for cap in (64, 512):
            got = segment_slice_gather(src, starts, cap)
            assert torch.equal(got, segment_slice_gather_plain(src, starts, cap))
    with pytest.raises(ValueError):
        segment_slice_gather(src.double(), starts, 64)


def _pdata(rng, n_tiles, tw, ts, cap, cp):
    tile = np.repeat(np.arange(n_tiles), cap)
    m = n_tiles * cap
    sx, sy = rng.uniform(0.5, 8.0, m), rng.uniform(0.5, 8.0, m)
    rho = rng.uniform(-0.8, 0.8, m)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows = [(tile % tw) * ts + rng.uniform(-4, ts + 4, m),
            (tile // tw) * ts + rng.uniform(-4, ts + 4, m),
            sy**2 / det, -rho * sx * sy / det, sx**2 / det,
            rng.uniform(0.0, 0.99, m)] + [rng.uniform(0, 1.5, m) for _ in range(cp)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("ts,cp", [(16, 4), (32, 4), (8, 5), (16, 6), (32, 7), (16, 8)])
def test_blend_kernel_matches_plain(dev, ts, cp):
    rng = np.random.default_rng(ts * 10 + cp)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(_pdata(rng, n_tiles, tw, ts, cap, cp)).to(dev)
    # 600 > cap: the kernel blends the first cap slots, as the plain version does.
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap)
    got = raster_tiles(pdata, counts, ts, tw, cfg)
    want = raster_tiles_plain(pdata, counts, ts, tw, cfg)
    torch.cuda.synchronize()
    assert got.shape == (n_tiles, cp + 1, ts * ts)
    diff = (got - want).abs()
    assert int((diff > 1e-5).sum()) <= 1e-4 * diff.numel()
    assert float(diff.max()) <= 5e-3
    assert torch.all(got[0, cp] == 1.0) and torch.all(got[0, :cp] == 0.0)


def test_blend_kernel_rejects_what_it_does_not_take(dev):
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    cfg = RenderConfig()
    with pytest.raises(ValueError):  # 9 channels
        raster_tiles(torch.zeros((15, 256), device=dev), counts, 16, 2, cfg)
    with pytest.raises(ValueError):  # 64x64 tiles exceed one block
        raster_tiles(torch.zeros((10, 256), device=dev), counts, 64, 2, cfg)
    with pytest.raises(ValueError):  # counts must be int32
        raster_tiles(torch.zeros((10, 256), device=dev), counts.long(), 16, 2, cfg)


@pytest.mark.parametrize("ts,cp", [(16, 4), (32, 4), (8, 5), (16, 6), (32, 7), (16, 8)])
def test_blend_bwd_kernel_matches_plain(dev, ts, cp):
    rng = np.random.default_rng(ts * 10 + cp + 1)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(_pdata(rng, n_tiles, tw, ts, cap, cp)).to(dev)
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    gout = torch.from_numpy(rng.normal(size=(n_tiles, cp + 1, ts * ts)).astype(np.float32)).to(dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)

    def kernel_grad():
        pd = pdata.clone().requires_grad_(True)
        raster_tiles(pd, counts, ts, tw, cfg).backward(gout)  # B1 with residual, then B2
        return pd.grad

    got = kernel_grad()
    want = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg)
    torch.cuda.synchronize()
    assert got.shape == pdata.shape and bool(torch.isfinite(got).all())
    scale = want.abs().amax(dim=1, keepdim=True) + 1e-12
    rel = (got - want).abs() / scale
    assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel()
    assert float(rel.max()) <= 1e-3
    d = got.reshape(6 + cp, n_tiles, cap)
    assert torch.all(d[:, 0] == 0) and torch.all(d[:, 1, 1:] == 0)  # nothing past a count
    assert torch.equal(kernel_grad(), got)  # no atomics: bitwise reproducible


def _edge_pdata(rng, n_tiles, tw, ts, cap, cp):
    """_pdata with the row test's edge cases mixed in: a <= 0, indefinite
    conics, opacities at the threshold on a pixel centre, slots far off
    the tile."""
    pd = _pdata(rng, n_tiles, tw, ts, cap, cp)
    k = np.arange(n_tiles * cap) % 9
    tile = np.repeat(np.arange(n_tiles), cap)
    pd[2, k == 1] = -0.2
    pd[3, k == 2] = np.sqrt(pd[2, k == 2] * pd[4, k == 2]) * 1.5
    sel = k == 3
    pd[5, sel] = np.float32(1.0 / 255.0)
    pd[0, sel] = (tile[sel] % tw) * ts + 3.5
    pd[1, sel] = (tile[sel] // tw) * ts + 1.5
    pd[0, k == 4] += 60.0
    return pd


@pytest.mark.parametrize("ts,cp", [(32, 4), (16, 6), (8, 5), (32, 8)])
def test_blend_skip_count_matches_mirror(dev, ts, cp):
    rng = np.random.default_rng(ts * 7 + cp)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(_edge_pdata(rng, n_tiles, tw, ts, cap, cp)).to(dev)
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap)
    skipped, stop = raster_tiles_skips(pdata, counts, ts, tw, cfg)
    out, (_, stop_r) = raster_tiles_fwd(pdata, counts, ts, tw, cfg, residual=True)
    torch.cuda.synchronize()
    assert torch.equal(stop, stop_r)
    assert torch.equal(out, raster_tiles(pdata, counts, ts, tw, cfg))
    may = row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    want = skipped_pairs_plain(may, counts, stop)
    assert torch.equal(skipped, want), (int(skipped.sum()), int(want.sum()))
    assert int(skipped.sum()) > 0


@pytest.mark.parametrize("ts,cp", [(32, 4), (16, 8)])
def test_blend_bwd_kernel_edge_slots(dev, ts, cp):
    rng = np.random.default_rng(ts + cp + 3)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(_edge_pdata(rng, n_tiles, tw, ts, cap, cp)).to(dev)
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    gout = torch.from_numpy(rng.normal(size=(n_tiles, cp + 1, ts * ts)).astype(np.float32)).to(dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)

    def kernel_grad():
        pd = pdata.clone().requires_grad_(True)
        raster_tiles(pd, counts, ts, tw, cfg).backward(gout)
        return pd.grad

    got = kernel_grad()
    want = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    # Where a <= 0 or the conic is indefinite, exp(-sigma) overflows at far
    # pixels and the plain version's 0 * inf is NaN; compare the rest.
    fin = torch.isfinite(want).all(dim=0)
    assert float(fin.float().mean()) > 0.7
    got, want = got[:, fin], want[:, fin]
    scale = want.abs().amax(dim=1, keepdim=True) + 1e-12
    rel = (got - want).abs() / scale
    assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel()
    assert float(rel.max()) <= 1e-3
    assert torch.equal(kernel_grad()[:, fin], got)
    shape = raster_bwd_shape(cp, ts)
    assert shape["cluster"] == 4, shape
    assert shape["threads"] == (256 if ts == 32 else 64) and shape["blocks_per_sm"] >= 2, shape


def test_segment_sum_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    M, S, F = 200_000, 50_000, 9
    # Sorted keys with empty segments, one long segment, and keys equal to and
    # past S, which are dropped.
    keys = np.sort(np.concatenate([
        rng.choice(np.arange(0, S, 3), M - 3000), np.full(1000, 9),
        np.full(1500, S), np.full(500, S + 9)])).astype(np.int32)
    cols = torch.from_numpy(rng.normal(size=(F, M)).astype(np.float32)).to(dev)
    keys = torch.from_numpy(keys).to(dev)
    got = segment_sum_cols(cols, keys, S)
    torch.cuda.synchronize()
    assert got.shape == (F, S)
    # Each segment in row order from 0: bit-equal to index_add_ on the CPU.
    assert torch.equal(got.cpu(), segment_sum_cols_plain(cols.cpu(), keys.cpu(), S))
    assert torch.all(got[:, 1::3] == 0)  # empty segments
    assert torch.equal(segment_sum_cols(cols, keys, S), got)
    with pytest.raises(ValueError):  # keys must be int32
        segment_sum_cols(cols, keys.long(), S)


def _segsum_keys(rng, S):
    """Sorted keys over S segments: window 0 (segments 0-255) empty,
    segments of 7,000 and 3,000 rows at either side of the boundary of
    windows 1 and 2 (511, 512), then nothing up to 767; from 768 about 6
    rows a segment, so that a window's rows are several times its 256
    threads, with empty segments between; one segment of 5,000 rows in the
    middle; the last 700 segments empty (whole empty windows of 256 at the
    end); keys equal to and past S."""
    body = rng.integers(768, S - 700, 6 * (S - 1468))
    body = body[body % 5 != 0]  # empty segments
    return np.sort(np.concatenate([
        body, np.full(7000, 511), np.full(3000, 512), np.full(5000, S // 2),
        np.full(900, S), np.full(300, S + 7)])).astype(np.int32)


@pytest.mark.parametrize("F", [1, 9, 18])
def test_segment_sum_kernel_bit_equal(dev, F):
    """B3 against its plain version on CPU copies of the same inputs, bit for
    bit: windows of many rows, segments of thousands of rows at a window
    boundary, S not a multiple of the 256-segment window, empty windows,
    every key >= S, no rows at all; with ``perm`` (the unsorted columns) and
    into ``out``; F = 1, 9 and 18 are one, three and six field groups."""
    rng = np.random.default_rng(40 + F)
    S = 20_000 + 77
    keys = _segsum_keys(rng, S)
    M = keys.shape[0]
    cols = torch.from_numpy(rng.normal(size=(F, M)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(M))
    want = segment_sum_cols_plain(cols, torch.from_numpy(keys), S)
    kd, cd = torch.from_numpy(keys).to(dev), cols.to(dev)
    got = segment_sum_cols(cd, kd, S)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(segment_sum_cols(cd, kd, S), got)
    assert bool((got[:, :511] == 0).all() and (got[:, 513:768] == 0).all()
                and (got[:, S - 700:] == 0).all())
    # perm: sorted row i is column perm[i] of the unsorted columns.
    unsorted = torch.empty_like(cols)
    unsorted[:, perm] = cols
    want_p = segment_sum_cols_plain(unsorted, torch.from_numpy(keys), S, perm=perm)
    assert torch.equal(want_p, want)
    got_p = segment_sum_cols(unsorted.to(dev), kd, S, perm=perm.to(dev))
    assert torch.equal(got_p.cpu(), want)
    # out: the first F rows of a larger buffer; the rows around it untouched.
    buf = torch.full((F + 2, S), 3.0, device=dev)
    res = segment_sum_cols(unsorted.to(dev), kd, S, perm=perm.to(dev), out=buf[1:F + 1])
    assert res.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1:F + 1], got)
    assert bool((buf[0] == 3.0).all() and (buf[F + 1] == 3.0).all())
    # Every key >= S, and no rows: all zeros.
    high = torch.full((M,), S, dtype=torch.int32, device=dev)
    high[M // 2:] = S + 1
    assert torch.equal(segment_sum_cols(cd, high, S), torch.zeros((F, S), device=dev))
    empty = segment_sum_cols(torch.zeros((F, 0), device=dev),
                             torch.zeros((0,), dtype=torch.int32, device=dev), S)
    assert torch.equal(empty, torch.zeros((F, S), device=dev))
    with pytest.raises(ValueError):  # perm must be int64
        segment_sum_cols(cd, kd, S, perm=perm.to(dev, torch.int32))
    with pytest.raises(ValueError):  # out must have (F, S)
        segment_sum_cols(cd, kd, S, out=buf[:F, :-1])


def test_segment_sum_kernel_launch_shape(dev):
    """B3: 256-thread blocks with no local memory, at least 4 resident an
    SM."""
    shape = segsum_shape()
    assert shape["threads"] == 256 and shape["local_bytes"] == 0, shape
    assert shape["blocks_per_sm"] >= 4, shape


@pytest.mark.parametrize("cap", [1, 3, 64, 100, 512, 4096])
def test_slice_kernel_caps(dev, cap):
    """B5 bit for bit at caps on and off the 16-byte path, with starts that
    are negative, unaligned, at M and past M; float32 payloads compared as
    int32 words, NaNs with payload bits among them."""
    rng = np.random.default_rng(cap)
    M = 9_001
    words = rng.integers(-2**31, 2**31 - 1, M, dtype=np.int64).astype(np.int32)
    words[::7] = np.int32(0x7FC01234)  # NaNs with payload bits
    words[::11] = np.int32(-0x3FFEDCC)  # negative NaNs
    src_i = torch.from_numpy(words).to(dev)
    starts = torch.tensor([-cap - 5, -3, 0, 1, 5, 127, 4001, M - cap, M - 3, M, M + 50],
                          dtype=torch.int32, device=dev)
    for src in (src_i, src_i.view(torch.float32)):
        got = segment_slice_gather(src, starts, cap)
        torch.cuda.synchronize()
        assert got.dtype == src.dtype and got.shape == (starts.shape[0] * cap,)
        want = segment_slice_gather_plain(src.cpu(), starts.cpu(), cap)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_gather_adjoint_bit_equal_to_cpu(dev):
    """The gather's adjoint on the card (the sort, B3 with perm into
    d_packed, the sink's rows) gives the CPU's gradients bit for bit: both
    add each gaussian's slots in slot order from 0. The 3DGS gather with and
    without the absgrad sink, and the surfel gather with the maps."""
    rng = np.random.default_rng(4)
    n, n_tiles, cap = 20_000, 300, 500
    m = n_tiles * cap
    ids = rng.integers(-1, n, m).astype(np.int32)
    counts = rng.integers(0, cap + 1, n_tiles).astype(np.int32)
    base3 = [rng.normal(size=s).astype(np.float32) for s in ((n, 2), (n, 3), (n, 3), (n,))]
    base2 = [rng.normal(size=n).astype(np.float32) for _ in range(18)]
    g3 = rng.normal(size=(10, m)).astype(np.float32)
    g2 = rng.normal(size=(18, m)).astype(np.float32)

    def grads(device, family, sink):
        t = [torch.from_numpy(b).to(device).requires_grad_(True)
             for b in (base3 if family == 3 else base2)]
        i, c = torch.from_numpy(ids).to(device), torch.from_numpy(counts).to(device)
        s = torch.zeros((n, 2), device=device, requires_grad=True) if sink else None
        if family == 3:
            out = gather_tile_data(*t, i, c, absgrad_sink=s)
            out.backward(torch.from_numpy(g3).to(device))
        else:
            out = gather_surfel_tile_data(t, i, c)
            out.backward(torch.from_numpy(g2).to(device))
        return [x.grad.cpu() for x in t] + ([s.grad.cpu()] if sink else [])

    for family, sink in ((3, False), (3, True), (2, False)):
        got, want = grads(dev, family, sink), grads("cpu", family, sink)
        for k, (x, y) in enumerate(zip(got, want)):
            assert torch.equal(x, y), (family, sink, k)


def test_gather_adjoint_is_deterministic(dev):
    rng = np.random.default_rng(3)
    n, n_tiles, cap, C = 20_000, 600, 500, 3
    m = n_tiles * cap
    ids = torch.from_numpy(rng.integers(-1, n, m).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(10, m)).astype(np.float32)).to(dev)
    counts = torch.from_numpy(rng.integers(0, cap + 1, n_tiles).astype(np.int32)).to(dev)
    # Past each tile's count the cotangent is dropped.
    live = (torch.arange(cap, device=dev)[None, :] < counts[:, None]).reshape(-1)
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((n, 2), (n, 3), (n, C), (n,))]

    def grads():
        ins = [b.clone().requires_grad_(True) for b in base]
        gather_tile_data(*ins, ids, counts).backward(g)
        return [t.grad for t in ins]

    a, b = grads(), grads()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # Against index_add_, the plain adjoint (another order of f32 adds).
    safe = ids.clamp(0, n - 1).long()
    want = torch.zeros((10, n), device=dev).index_add_(1, safe, g * live)
    torch.testing.assert_close(a[0], want[0:2].T, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a[3], want[5], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ts,aux", [(16, False), (32, False), (8, True), (16, True),
                                    (32, True)])
def test_surfel_kernels_match_plain(dev, ts, aux):
    rng = np.random.default_rng(ts * 10 + aux)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(surfel_pdata(rng, n_tiles, tw, ts, cap, aux)).to(dev)
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    oc = 9 if aux else 5
    gout = torch.from_numpy(rng.normal(size=(n_tiles, oc, ts * ts)).astype(np.float32)).to(dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)
    # B6 / B7 against the plain forward (the B1 rule).
    got = raster_surfel_tiles(pdata, counts, ts, tw, cfg, aux)
    want = raster_surfel_tiles_plain(pdata, counts, ts, tw, cfg, aux)
    torch.cuda.synchronize()
    assert got.shape == (n_tiles, oc, ts * ts)
    # The depth moments are in scene units (z ~ 4, z^2 ~ 16): relative to
    # each output row's largest value.
    scale = want.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    diff = (got - want).abs() / scale
    assert int((diff > 1e-5).sum()) <= 1e-4 * diff.numel()
    assert float(diff.max()) <= 5e-3
    assert torch.all(got[0, -1] == 1.0) and torch.all(got[0, :-1] == 0.0)

    # B8 against the plain backward (the B2 rule), bitwise reproducible.
    def kernel_grad():
        pd = pdata.clone().requires_grad_(True)
        raster_surfel_tiles(pd, counts, ts, tw, cfg, aux).backward(gout)
        return pd.grad

    d_got = kernel_grad()
    d_want = raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg, aux)
    torch.cuda.synchronize()
    assert d_got.shape == pdata.shape and bool(torch.isfinite(d_got).all())
    rel = (d_got - d_want).abs() / (d_want.abs().amax(dim=1, keepdim=True) + 1e-12)
    assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel()
    assert float(rel.max()) <= 1e-3
    d = d_got.reshape(pdata.shape[0], n_tiles, cap)
    assert torch.all(d[:, 0] == 0) and torch.all(d[:, 1, 1:] == 0)  # nothing past a count
    assert torch.equal(kernel_grad(), d_got)


@pytest.mark.parametrize("ts,aux", [(8, False), (16, False), (32, False), (8, True),
                                    (16, True), (32, True)])
def test_surfel_bwd_kernel_edge_slots(dev, ts, aux):
    rng = np.random.default_rng(ts * 3 + aux + 5)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(surfel_edge_pdata(rng, n_tiles, tw, ts, cap, aux)).to(dev)
    counts = torch.tensor([0, 1, 15, 16, 17, 31, 255, 256, 257, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    oc = 9 if aux else 5
    gout = torch.from_numpy(rng.normal(size=(n_tiles, oc, ts * ts)).astype(np.float32)).to(dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)

    def kernel_grad():
        pd = pdata.clone().requires_grad_(True)
        raster_surfel_tiles(pd, counts, ts, tw, cfg, aux).backward(gout)
        return pd.grad

    _, (_, stop) = raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg, aux, True)
    got = kernel_grad()
    want = raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg, aux)
    torch.cuda.synchronize()
    assert int(stop[10].max()) < 64  # tile 10 stops early
    assert got.shape == pdata.shape and bool(torch.isfinite(got).all())
    rel = (got - want).abs() / (want.abs().amax(dim=1, keepdim=True) + 1e-12)
    assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel()
    assert float(rel.max()) <= 1e-3
    d = got.reshape(pdata.shape[0], n_tiles, cap)
    assert torch.all(d[:, 0] == 0) and torch.all(d[:, 1, 1:] == 0)  # nothing past a count
    assert torch.all(d[:, 11, 48:64] == 0)  # the chunk no pixel applies
    assert torch.equal(kernel_grad(), got)
    shape = surfel_bwd_shape(aux, ts)
    assert shape["cluster"] == 4, shape
    assert shape["threads"] == {8: 32, 16: 64, 32: 256}[ts], shape
    assert shape["blocks_per_sm"] >= 3 and shape["local_bytes"] == 0, shape


@pytest.mark.parametrize("ts,aux", [(8, False), (16, False), (32, False), (8, True),
                                    (16, True), (32, True)])
def test_surfel_fwd_kernel_edge_slots(dev, ts, aux):
    rng = np.random.default_rng(ts * 5 + aux + 11)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(grazing_pdata(rng, n_tiles, tw, ts, cap, aux)).to(dev)
    # Tile 10 stops early; tile 11 (600 > cap) holds a chunk no pixel applies.
    counts = torch.tensor([0, 1, 15, 16, 17, 255, 256, 257, 511, 512, 300, 600],
                          dtype=torch.int32, device=dev)
    oc = 9 if aux else 5
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)
    got = raster_surfel_tiles(pdata, counts, ts, tw, cfg, aux)
    got_r, (tchunk, stop) = raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg, aux, True)
    skip = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, aux)
    full = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, aux, walk_all=True)
    want = raster_surfel_tiles_plain(pdata, counts, ts, tw, cfg, aux)
    want_stop = surfel_stop_plain(pdata, counts, ts, tw, cfg, aux)
    may = surfel_row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    torch.cuda.synchronize()
    assert got.shape == (n_tiles, oc, ts * ts) and torch.equal(got_r, got)
    scale = want.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    diff = (got - want).abs() / scale
    assert int((diff > 1e-5).sum()) <= 1e-4 * diff.numel()
    assert float(diff.max()) <= 5e-3
    assert torch.all(got[0, -1] == 1.0) and torch.all(got[0, :-1] == 0.0)
    # The serial walk's stops: a flip of a threshold or stop decision moves
    # at most 0.1% of them.
    assert stop.shape == want_stop.shape == (n_tiles, ts * ts)
    assert int((stop != want_stop).sum()) <= 1e-3 * stop.numel()
    assert int(stop[10].max()) < 64 and int(stop[0].max()) == 0
    assert bool((stop <= counts.clamp(max=cap)[:, None]).all())
    # The row skip against the full walk: output, stops and every chunk T
    # below a stop bit for bit; its count of skipped (row, slot) pairs equal
    # to the plain mirror's from the kernel's own stops.
    live = (torch.arange(tchunk.shape[1], device=dev)[None, :, None] * 16) < stop[:, None, :]
    for out_c, tchunk_c, stop_c in (skip[:3], full[:3]):
        assert torch.equal(out_c.view(torch.int32), got.view(torch.int32))
        assert torch.equal(stop_c, stop)
        assert torch.equal(tchunk_c.view(torch.int32)[live], tchunk.view(torch.int32)[live])
    assert int(full[3].abs().sum()) == 0
    want_skipped = surfel_skipped_pairs_plain(may, counts, stop)
    assert torch.equal(skip[3], want_skipped), (int(skip[3].sum()), int(want_skipped.sum()))
    assert int(skip[3].sum()) > 0
    for residual in (False, True):
        shape = surfel_fwd_shape(aux, ts, residual)
        assert shape["cluster"] == 1 and shape["threads"] == {8: 64, 16: 256, 32: 256}[ts], shape
        assert shape["blocks_per_sm"] * shape["threads"] // 32 >= 32, shape
        assert shape["local_bytes"] == 0, shape


def test_surfel_kernels_reject_what_they_do_not_take(dev):
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    cfg = RenderConfig()
    with pytest.raises(ValueError):  # 16 rows are the plain variant, not the maps
        raster_surfel_tiles(torch.zeros((16, 256), device=dev), counts, 16, 2, cfg, True)
    with pytest.raises(ValueError):  # 64x64 tiles exceed one block
        raster_surfel_tiles(torch.zeros((16, 256), device=dev), counts, 64, 2, cfg)


@pytest.mark.parametrize("ts,cp,chunk", [(16, 4, 256), (32, 4, 128), (8, 6, 64)])
def test_probe_kernels_match_plain(dev, ts, cp, chunk):
    rng = np.random.default_rng(ts + cp + chunk)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(_pdata(rng, n_tiles, tw, ts, cap, cp)).to(dev)
    counts = torch.tensor([0, 1, 2, 31, 255, 256, 257, 300, 400, 511, 512, 600],
                          dtype=torch.int32, device=dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap)
    b1 = raster_tiles(pdata, counts, ts, tw, cfg)
    for variant in VARIANTS:
        got = raster_variant(variant, pdata, counts, ts, tw, cfg, chunk)
        want = raster_variant_plain(variant, pdata, counts, ts, tw, cfg, chunk)
        torch.cuda.synchronize()
        assert got.shape == (n_tiles, cp + 1, ts * ts), variant
        scale = want.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1e-30)
        diff = (got - want).abs() / scale
        if variant in ("blend", "memonly"):
            assert float(diff.max()) <= 1e-6, variant
        else:
            # The plain blend1/blend3 walk the kernel's f32 chain, so they
            # meet at f32 rounding, far inside the bf16 product's effect.
            atol = 1e-7 if variant in ("blend1", "blend3") else 1e-5
            assert int((diff > atol).sum()) <= 1e-4 * diff.numel(), variant
            assert float(diff.max()) <= 5e-3, variant
            if atol < 1e-5:
                moved = ((want - b1).abs() / scale > atol).float().mean()
                assert float(moved) >= 1e-2, variant
        assert torch.all(got[0, cp] == 1.0) and torch.all(got[0, :cp] == 0.0), variant
        if variant == "full":
            assert torch.equal(got, b1)
    with pytest.raises(ValueError):  # the chunk must divide the tile capacity
        raster_variant("noscan", pdata, counts, ts, tw, cfg, 96)


def test_tight_cull_and_sinks_match_torch_route(dev):
    rng = np.random.default_rng(7)
    n, H, W = 3000, 96, 160
    means = np.concatenate([rng.normal(0, 1.0, (n, 2)), rng.uniform(1.5, 6.0, (n, 1))], 1)
    scales = np.stack([rng.normal(-2.0, 0.4, n), rng.normal(-3.8, 0.4, n),
                       rng.normal(-3.0, 0.2, n)], 1)
    p = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in dict(
        means3d=means, scales=scales, quats=rng.normal(size=(n, 4)),
        opacities=rng.uniform(0.02, 0.95, n), features=rng.uniform(0, 1, (n, 3))).items()}
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=120.0, fy=120.0, cx=W / 2,
                        cy=H / 2, device=dev)
    w = torch.from_numpy(rng.normal(size=(H, W, 3)).astype(np.float32)).to(dev)
    out = {}
    for route in ("torch", "cuda"):
        cfg = RenderConfig(raster_impl=route, tight_cull=True, max_tile_span=8,
                           tile_capacity=256)
        sinks = [torch.zeros((n, 2), device=dev, requires_grad=True) for _ in range(2)]
        img, aux = render_gaussians(*(p[k] for k in ("means3d", "scales", "quats", "opacities",
                                                     "features")), cam, config=cfg,
                                    return_aux=True, means2d_offset=sinks[0],
                                    absgrad_sink=sinks[1])
        (img * w).sum().backward()
        out[route] = (img.detach(), aux.binning, [s.grad for s in sinks])
    torch.cuda.synchronize()
    (img_t, bin_t, g_t), (img_c, bin_c, g_c) = out["torch"], out["cuda"]
    assert int(bin_c.tight_culled) > 0
    for name in bin_t._fields:
        assert int(getattr(bin_c, name)) == int(getattr(bin_t, name)), name
    diff = (img_c - img_t).abs()
    assert int((diff > 1e-5).sum()) <= 1e-4 * diff.numel() and float(diff.max()) <= 5e-3
    for got, want in zip(g_c, g_t):
        rel = (got - want).abs() / (want.abs().amax() + 1e-12)
        assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel() and float(rel.max()) <= 1e-3
    assert bool((g_c[1] >= g_c[0].abs() - 1e-6 * g_c[0].abs().amax()).all())


# The camera models (3DGS through B4, B5, B1, B2 and B3; ortho disks
# through B6 and B8 without the maps): the "cuda" route against the "torch"
# route on the same inputs, renders by B1's rule and gradients by B2's.
CAMERA_CASES = {
    "pinhole-ut": (dict(dist=[0.05, -0.01, 1e-3, -2e-3, 0.002]), dict(projection_mode="ut")),
    "fisheye": (dict(camera_model="fisheye", dist=[0.08, -0.01, 0.002, -0.0005, 0.0]), dict()),
    "rolling": (dict(shutter="rolling", rs_vel=[0.05, 0.08, 0.02, 0.1, -0.05, 0.2]), dict()),
    "ortho": (dict(camera_model="ortho", fx=30.0, fy=30.0), dict()),
}


def _camera_scene(dev, n, H, W, cam_kw, seed, disks=False):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 1.0, (n, 2)), rng.uniform(1.5, 6.0, (n, 1))], 1)
    p = dict(means3d=means, scales=rng.normal(-2.4, 0.4, (n, 2 if disks else 3)),
             quats=rng.normal(size=(n, 4)), opacities=rng.uniform(0.05, 0.95, n),
             features=rng.uniform(0, 1, (n, 3)))
    p = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in p.items()}
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, **dict(
        dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2), **cam_kw), device=dev)
    return p, cam


def _route_rules(name, img_c, img_t, grads_c, grads_t, share=1e-4, max_err=5e-3,
                 grad_share=1e-5, grad_max=1e-3):
    """B1's rule on the images and B2's on each gradient (scaled by its
    largest magnitude), or the shares and maxima given."""
    diff = (img_c - img_t).abs()
    assert int((diff > 1e-5).sum()) <= share * diff.numel(), name
    assert float(diff.max()) <= max_err, name
    for k, (got, want) in enumerate(zip(grads_c, grads_t)):
        assert bool(torch.isfinite(got).all()), (name, k)
        rel = (got - want).abs() / (want.abs().amax() + 1e-12)
        assert int((rel > 1e-4).sum()) <= grad_share * rel.numel(), (name, k)
        assert float(rel.max()) <= grad_max, (name, k)


@pytest.mark.parametrize("case", list(CAMERA_CASES))
def test_camera_models_cuda_route_matches_torch(dev, case):
    cam_kw, cfg_kw = CAMERA_CASES[case]
    H, W, n = 96, 160, 2000
    p, cam = _camera_scene(dev, n, H, W, cam_kw, seed=len(case))
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(H, W, 3)).astype(np.float32)).to(dev)
    out = {}
    for route in ("torch", "cuda"):
        cfg = RenderConfig(raster_impl=route, tile_capacity=256, **cfg_kw)
        means = p["means3d"].clone().requires_grad_(True)
        delta = torch.zeros(6, device=dev, requires_grad=True)
        img, aux = render_gaussians(means, *(p[k] for k in ("scales", "quats", "opacities",
                                                           "features")),
                                    apply_pose_delta(cam, delta), config=cfg, return_aux=True)
        (img * w).sum().backward()
        out[route] = (img.detach(), aux.binning, [means.grad, delta.grad[None]])
    torch.cuda.synchronize()
    (img_t, bin_t, g_t), (img_c, bin_c, g_c) = out["torch"], out["cuda"]
    for name in bin_t._fields:
        assert int(getattr(bin_c, name)) == int(getattr(bin_t, name)), name
    assert int(bin_c.num_isects) > 0 and float(img_c.std()) > 0.02
    _route_rules(case, img_c, img_t, g_c, g_t)


def camera_to(cam, device):
    """The camera with its tensors on ``device``."""
    return dataclasses.replace(cam, **{f.name: getattr(cam, f.name).to(device)
                                       for f in dataclasses.fields(cam)
                                       if isinstance(getattr(cam, f.name), torch.Tensor)})


def test_ortho_disks_cuda_route_matches_torch(dev):
    """Ortho disks without the maps through B6 and B8 (aux=False), against
    the same route's plain versions on the CPU and the "torch" route; B6's
    row skip on the ortho records bit-equal to the
    full walk, its count the plain mirror's; with the maps, and for the
    fisheye, the "cuda" route raises as the reference's "pallas" route."""
    H, W, n = 96, 160, 2000
    p, cam = _camera_scene(dev, n, H, W, CAMERA_CASES["ortho"][0], seed=3, disks=True)
    keys = ("means3d", "scales", "quats", "opacities", "features")
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(H, W, 3)).astype(np.float32)).to(dev)
    out = {}
    for route, device in (("torch", dev), ("cuda", dev), ("cuda", "cpu")):
        cfg = RenderConfig(raster_impl=route, tile_capacity=256)
        means = p["means3d"].clone().to(device).requires_grad_(True)
        img = render_surfels(means, *(p[k].to(device) for k in keys[1:]),
                             camera_to(cam, device), config=cfg)
        (img * w.to(device)).sum().backward()
        out[route, str(device)] = (img.detach().to(dev), [means.grad.to(dev)])
    torch.cuda.synchronize()
    # The kernels against their plain versions on CPU copies (the same
    # primed coordinates): B1's and B2's rules.
    _route_rules("ortho disks, kernels", *out["cuda", str(dev)][:1], *out["cuda", "cpu"][:1],
                 out["cuda", str(dev)][1], out["cuda", "cpu"][1])
    # The two routes compute the alpha in other coordinates: chip_smoke.py's
    # route rule (renders: 0.1% of values off by 1e-5, none by 2e-2;
    # gradients: none off by 1e-2 of the scale, and 0.1% by 1e-4, since
    # one value of these 6,000 is 1.7e-4 of them).
    _route_rules("ortho disks, routes", out["cuda", str(dev)][0], out["torch", str(dev)][0],
                 out["cuda", str(dev)][1], out["torch", str(dev)][1], share=1e-3, max_err=2e-2,
                 grad_share=1e-3, grad_max=1e-2)
    cfg = RenderConfig(raster_impl="cuda", tile_capacity=256)
    ts = cfg.tile_size
    tw = -(-W // ts)
    with torch.no_grad():
        bins = bin_surfels(*(p[k] for k in keys[:4]), cam, cfg)
        pdata, counts = pack_surfel_tiles(*(p[k] for k in keys), cam, bins, cfg, False)
        assert bool((pdata[5] == 0).all() and (pdata[8] == 0).all())  # ortho: a2 = b2 = 0
        skip = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, False)
        full = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, False, walk_all=True)
        may = surfel_row_may_apply_plain(pdata, counts.shape[0], ts, tw, cfg)
    torch.cuda.synchronize()
    stop = skip[2]
    live = (torch.arange(skip[1].shape[1], device=dev)[None, :, None] * 16) < stop[:, None, :]
    assert torch.equal(skip[0].view(torch.int32), full[0].view(torch.int32))
    assert torch.equal(skip[2], full[2])
    assert torch.equal(skip[1].view(torch.int32)[live], full[1].view(torch.int32)[live])
    assert torch.equal(skip[3], surfel_skipped_pairs_plain(may, counts, stop))
    assert int(skip[3].sum()) > 0
    for camera, maps in ((cam, True), (dataclasses.replace(cam, camera_model="fisheye"), False)):
        with pytest.raises(NotImplementedError):
            render_surfels(*(p[k] for k in keys), camera, config=cfg, return_depth=maps)


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_surfel_kernels_on_ortho_records(dev, ts):
    """B6 and B8 (aux=False) on ortho-primed records (z rows (1, 0, 0)) with
    edge-on and nearly edge-on disks and threshold opacities: B6 by B1's
    rule against the plain forward, its row skip bit-equal to the full walk
    and its skip count the mirror's, no skipped (row, slot) pair kept by a
    pixel (brute force); B8 by B2's rule, bitwise reproducible."""
    rng = np.random.default_rng(ts + 101)
    n_tiles, tw, cap = 12, 4, 512
    pdata = torch.from_numpy(ortho_pdata(rng, n_tiles, tw, ts, cap, False)).to(dev)
    counts = torch.tensor([0, 1, 15, 16, 17, 255, 256, 257, 511, 512, 300, 600],
                          dtype=torch.int32, device=dev)
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, tile_batch=4)
    got = raster_surfel_tiles(pdata, counts, ts, tw, cfg, False)
    want = raster_surfel_tiles_plain(pdata, counts, ts, tw, cfg, False)
    skip = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, False)
    full = raster_surfel_tiles_check(pdata, counts, ts, tw, cfg, False, walk_all=True)
    may = surfel_row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    diff = (got - want).abs() / scale
    assert int((diff > 1e-5).sum()) <= 1e-4 * diff.numel() and float(diff.max()) <= 5e-3
    stop = skip[2]
    live = (torch.arange(skip[1].shape[1], device=dev)[None, :, None] * 16) < stop[:, None, :]
    assert torch.equal(skip[0].view(torch.int32), got.view(torch.int32))
    assert torch.equal(full[0].view(torch.int32), got.view(torch.int32))
    assert torch.equal(full[2], stop)
    assert torch.equal(skip[1].view(torch.int32)[live], full[1].view(torch.int32)[live])
    assert torch.equal(skip[3], surfel_skipped_pairs_plain(may, counts, stop))
    assert int(skip[3].sum()) > 0
    pd = pdata.reshape(pdata.shape[0], n_tiles, cap)
    _, _, geo = _surfel_geometry_all(pd, n_tiles, ts, tw, cap, cfg)
    kept = geo["keep"].reshape(n_tiles, ts, ts, cap).any(dim=2)
    assert not bool((kept & ~may).any())
    gout = torch.from_numpy(rng.normal(size=(n_tiles, 5, ts * ts)).astype(np.float32)).to(dev)
    # The backward on the same records with the NaN opacities at 0 (a NaN
    # opacity's gradients are NaN on both sides).
    pdata = pdata.clone()
    pdata[11] = torch.nan_to_num(pdata[11], nan=0.0)

    def kernel_grad():
        p = pdata.clone().requires_grad_(True)
        raster_surfel_tiles(p, counts, ts, tw, cfg, False).backward(gout)
        return p.grad

    d_got = kernel_grad()
    d_want = raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg, False)
    torch.cuda.synchronize()
    rel = (d_got - d_want).abs() / (d_want.abs().amax(dim=1, keepdim=True) + 1e-12)
    assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel() and float(rel.max()) <= 1e-3
    assert torch.equal(kernel_grad(), d_got)


def _surfel_geometry_all(pd, n_tiles, ts, tw, cap, cfg):
    from mojosplat_tpu_torch.ops.surfel_cuda import _surfel_geometry

    counts = torch.full((n_tiles,), cap, dtype=torch.int32, device=pd.device)
    return _surfel_geometry(torch.arange(n_tiles, device=pd.device), pd, 0, cap, counts, ts,
                            tw, cfg, False)


def test_colmap_cli_step_cuda_route_matches_torch(dev, tmp_path):
    """One step loss of the train_colmap CLI (--depth-loss --pose-opt
    --exposure-opt --bilagrid --intrinsics-opt, the default SSIM weight)
    at tests/test_train_colmap_cli.py's 64x48 capture, its targets rendered
    from a seeded numpy cloud: the "cuda" route (B4, B5, B1, B2 and B3 each
    launched once) against the "torch" route on the card; the loss within
    1e-5 and every gradient, of the gaussians and of the view groups, by
    B2's rule."""
    from mojosplat_tpu_torch.examples import train_colmap
    from mojosplat_tpu_torch.ops import expand_cuda, raster_cuda, segsum_cuda, slice_cuda
    from mojosplat_tpu_torch.utils import colmap as cm
    from torch_colmap_cases import train_capture

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    n = 200
    cloud = dict(means3d=rng.normal(0, 0.4, (n, 3)) + [0, 0, 2.0],
                 scales=rng.normal(-2.0, 0.3, (n, 3)), quats=rng.normal(size=(n, 4)),
                 opacities_raw=rng.normal(1.0, 1.0, n),
                 features=rng.uniform(-0.5, 0.5, (n, 1, 3)))
    capture = train_capture(tmp_path, {k: v.astype(np.float32) for k, v in cloud.items()})
    scene = cm.load_scene(str(capture / "sparse" / "0"), with_points2d=True)
    views, images = train_colmap.load_view_images(str(capture), scene, 1)
    depth = [torch.from_numpy(a[1]).to(dev) for a in cm.sparse_depth_targets(scene, views, 1)]
    raw = cm.init_gaussians_from_points(scene.points_xyz, scene.points_rgb, sh_degree=1)
    # Anisotropic splats, so that the quaternions have a gradient.
    raw["scales"] = (raw["scales"] + rng.normal(0, 0.3, raw["scales"].shape)).astype(np.float32)
    raw["quats"] = rng.normal(size=raw["quats"].shape).astype(np.float32)
    vp0 = dict(pose=rng.normal(0, 2e-3, (2, 6)),
               expo=np.eye(3, 4) + rng.normal(0, 0.02, (2, 3, 4)),
               intr=rng.normal(0, [1e-3, 1e-3, 0.3, 0.3], (2, 4)),
               bgrid=np.concatenate([np.eye(3).reshape(9), np.zeros(3)])
               + rng.normal(0, 0.02, (2, 16, 16, 8, 12)))
    counters = (expand_cuda.segment_expand_offsets, slice_cuda.segment_slice_gather,
                raster_cuda.raster_tiles, raster_cuda.raster_tiles_bwd,
                segsum_cuda.segment_sum_cols)
    out = {}
    for route in ("torch", "cuda"):
        args = train_colmap.build_parser().parse_args(
            ["--data", str(capture), "--impl", route, "--sh-degree", "1", "--depth-loss", "0.05",
             "--pose-opt", "--exposure-opt", "--bilagrid", "--intrinsics-opt"])
        params = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in raw.items()}
        vp = {k: torch.from_numpy(v.astype(np.float32)).to(dev).requires_grad_(True)
              for k, v in vp0.items()}
        for fn in counters:
            fn.launches = 0
        loss, _ = train_colmap.step_loss(
            params, vp, 1, scene.camera_for(views[1], 1, device=dev),
            torch.from_numpy(images[1]).to(dev), depth, args,
            train_colmap.render_config(args, surfels=False), 1)
        loss.backward()
        torch.cuda.synchronize()
        out[route] = (loss.item(), [t.grad for t in params.values()] + [
            t.grad.reshape(2, -1) for t in vp.values()], [fn.launches for fn in counters])
    (loss_t, g_t, n_t), (loss_c, g_c, n_c) = out["torch"], out["cuda"]
    assert n_t == [0] * 5 and n_c == [1] * 5, (n_t, n_c)
    assert abs(loss_c - loss_t) <= 1e-5 * abs(loss_t)
    for k, (got, want) in enumerate(zip(g_c, g_t)):
        assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0, k
        rel = (got - want).abs() / want.abs().amax()
        assert int((rel > 1e-4).sum()) <= 1e-5 * rel.numel() and float(rel.max()) <= 1e-3, k


def test_dense_oracle_matches_cuda_route(dev):
    """The port's dense oracle (global depth sort, analytic tile
    membership) against the "cuda" route's render (B4, B5, B1) on the
    same projection, by B1's rule."""
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.rasterization import rasterize_dense_oracle, rasterize_gaussians

    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = 128, 192
    p, cam = _camera_scene(dev, 2000, H, W, {}, seed=3)
    cfg = RenderConfig(raster_impl="cuda", tile_capacity=512, isect_padding_multiplier=16)
    proj = project_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"], cam, cfg)
    binning = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    img, aux = rasterize_gaussians(proj.means2d, proj.conics, p["features"], p["opacities"], bg,
                                   binning, H, W, cfg)
    oracle = rasterize_dense_oracle(proj.means2d, proj.conics, p["features"], p["opacities"],
                                    bg, proj.depths, proj.radii, H, W, cfg)
    assert int(aux.tile_overflow) == 0 and int(binning.aux.capacity_overflow) == 0
    _route_rules("dense oracle", img, oracle, [], [])


def test_tsdf_fuse_cuda_matches_cpu(dev):
    """tests/test_mesh.py's sphere: its depth and alpha maps rendered on the
    "cuda" route (B7), fused on the card and on the CPU: the TSDF within
    1e-5 where both weights agree, the weights differing on under 1e-4 of
    the voxels (threshold flips)."""
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.examples.extract_mesh import depth_view
    from mojosplat_tpu_torch.utils.mesh import tsdf_fuse
    from torch_scene_tools_cases import sphere_cameras, surfel_sphere

    p = params_from_numpy(surfel_sphere(), dev)
    cfg = RenderConfig(tile_capacity=256, chunk_size=64, raster_impl="cuda")
    cams = sphere_cameras(dev)
    depths, alphas = zip(*(depth_view(p, cam, None, cfg) for cam in cams))
    bounds, res = ((-1.1,) * 3, (1.1,) * 3), 96
    t_c, w_c, _, _ = tsdf_fuse(depths, alphas, cams, bounds, res)
    t_h, w_h, _, _ = tsdf_fuse([d.cpu() for d in depths], [a.cpu() for a in alphas],
                               [camera_to(c, "cpu") for c in cams], bounds, res)
    assert (w_h > 0).mean() > 0.2
    assert int((w_c != w_h).sum()) < 1e-4 * w_h.size
    same = w_c == w_h
    np.testing.assert_allclose(t_c[same], t_h[same], rtol=0, atol=1e-5)


def test_sphere_reconstruction_cuda_route(dev):
    """tests/test_mesh.py's end-to-end reconstruction on the "cuda" route
    and the card, under that test's radius bounds."""
    from torch_scene_tools_cases import (
        SPHERE_MEDIAN_VOXELS, SPHERE_P90_VOXELS, reconstruct_sphere)

    out = reconstruct_sphere("cuda", dev)
    assert out["observed"] > 0.2 and len(out["faces"]) > 1000
    assert out["median_voxels"] < SPHERE_MEDIAN_VOXELS and out["p90_voxels"] < SPHERE_P90_VOXELS


def test_viewer_handler_cuda(dev, tmp_path):
    """The viewer's /render body on the card: the decoded PNG equals
    ``to_uint8`` of a direct "cuda"-route render of the view, and a request
    launches B4, B5 and B1 once each."""
    import io

    from PIL import Image

    from mojosplat_tpu_torch.examples import viewer
    from mojosplat_tpu_torch.ops import expand_cuda, raster_cuda, slice_cuda
    from mojosplat_tpu_torch.utils.image import to_uint8
    from mojosplat_tpu_torch.utils.ply import save_gaussian_ply

    rng = np.random.default_rng(2)
    n = 3000
    save_gaussian_ply(str(tmp_path / "s.ply"), dict(
        means3d=rng.normal(0, 1.0, (n, 3)), scales=rng.normal(-3.0, 0.3, (n, 3)),
        quats=rng.normal(size=(n, 4)), opacities_raw=rng.normal(1.0, 1.0, n),
        features=rng.uniform(-0.5, 0.5, (n, 4, 3))))
    v = viewer.build_viewer(["--ply", str(tmp_path / "s.ply"), "--height", "120",
                             "--width", "200"])
    counters = (expand_cuda.segment_expand_offsets, slice_cuda.segment_slice_gather,
                raster_cuda.raster_tiles)
    for fn in counters:
        fn.launches = 0
    body = v.png(0.7, 0.1, v.radius0)
    assert [fn.launches for fn in counters] == [1, 1, 1]
    want = to_uint8(v.render(0.7, 0.1, v.radius0).cpu().numpy())
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body)).convert("RGB")), want)


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_viewport_slabs_match_full_render(dev, family):
    """``viewport_rows`` on the "cuda" route (B1/B2, or B7/B8 with the maps):
    2 and 4 slabs of a 128-row view against the rows of the full render by
    B1's rule, and the gradient of the summed slab losses against the full
    render's by B2's rule. The slab's y shift rounds otherwise than the
    full render (for disks it sits in the primed columns), so the rules,
    not bit-equality."""
    H, W, n = 128, 160, 2000
    disks = family == "2dgs"
    p, cam = _camera_scene(dev, n, H, W, {}, seed=11, disks=disks)
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.normal(size=(H, W, 3)).astype(np.float32)).to(dev)
    wd = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32)).to(dev) * 0.1
    # Room for every slot: the full render and a slab drop no intersection.
    cfg = RenderConfig(raster_impl="cuda", tile_capacity=256, isect_padding_multiplier=16)
    keys = ("scales", "quats", "opacities", "features")

    def run(viewports):
        means = p["means3d"].clone().requires_grad_(True)
        imgs, loss = [], 0.0
        for row0, h in viewports:
            rows = slice(row0, row0 + h)
            if disks:
                img, depth, _ = render_surfels(means, *(p[k] for k in keys), cam, config=cfg,
                                               return_depth=True, return_normals=True,
                                               viewport_rows=(row0, h))
                loss = loss + (depth * wd[rows]).sum()
            else:
                img = render_gaussians(means, *(p[k] for k in keys), cam, config=cfg,
                                       viewport_rows=(row0, h))
            loss = loss + (img * w[rows]).sum()
            imgs.append(img.detach())
        loss.backward()
        return torch.cat(imgs), means.grad

    img_full, g_full = run([(0, H)])
    assert float(img_full.std()) > 0.02
    for n_slab in (2, 4):
        h = H // n_slab
        img, g = run([(i * h, h) for i in range(n_slab)])
        torch.cuda.synchronize()
        _route_rules(f"{family} {n_slab} slabs", img, img_full, [g], [g_full])
    render = render_surfels if disks else render_gaussians
    with pytest.raises(ValueError):  # not whole tile rows
        render(p["means3d"], *(p[k] for k in keys), cam, config=cfg, viewport_rows=(0, 40))


def test_benchmark_run_pipeline_routes_agree(dev):
    """The benchmark CLI's run_pipeline at a small size: the same
    num_isects on both routes (one untimed call a stage)."""
    from mojosplat_tpu_torch.examples import benchmark

    def untimed(impl, name, fn, fn_args, iters):
        fn(*fn_args)
        return 0.0

    args = benchmark.build_parser().parse_args(["--height", "128", "--width", "192"])
    cam = benchmark.create_camera(args.height, args.width, device=dev)
    got = {impl: benchmark.run_pipeline(args, cam, impl, 20_000, untimed)
           for impl in ("torch", "cuda")}
    assert got["cuda"]["num_isects"] == got["torch"]["num_isects"] > 0


def test_synth_capture_view_cuda_route_matches_torch(dev):
    """One view of the capture maker's scene (detail 0.1) with its config
    and camera: the "cuda" route against the "torch" route by B1's rule."""
    from mojosplat_tpu_torch.examples import make_synth_colmap as ms

    gt = ms.build_scene(np.random.default_rng(7), 0.1)
    gt = {k: torch.from_numpy(v).to(dev) for k, v in gt.items()}
    R, T = ms.ring_cameras(4)[1]
    cam = ms.view_camera(R, T, 128, 128, device=dev)
    imgs = {impl: ms.render_view(gt, cam, ms.render_config(impl)) for impl in ("torch", "cuda")}
    assert float(imgs["cuda"].std()) > 0.02
    _route_rules("maker view", imgs["cuda"], imgs["torch"], [], [])
