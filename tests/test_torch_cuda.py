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
other orders; a flip would move one pixel's share of a slot's sum). B3 agrees with index_add_ within rtol 1e-5
(another order of f32 adds) and is bitwise equal to itself, as are the
gradients of the packed gather.
"""

import numpy as np
import pytest
import torch

from mojosplat_tpu_torch import RenderConfig
from mojosplat_tpu_torch.ops.expand_cuda import (
    segment_expand_offsets, segment_expand_offsets_plain)
from mojosplat_tpu_torch.ops.raster_cuda import (
    gather_tile_data, raster_tiles, raster_tiles_bwd_plain, raster_tiles_plain)
from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols, segment_sum_cols_plain
from mojosplat_tpu_torch.ops.slice_cuda import (
    segment_slice_gather, segment_slice_gather_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_expand_kernel_exact(dev):
    rng = np.random.default_rng(0)
    n = 5000
    counts = rng.integers(0, 12, n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0
    counts[-100:] = 0
    offsets = np.cumsum(counts) - counts
    fields = np.stack([offsets] + [rng.integers(-5, 1 << 30, n) for _ in range(4)])
    fields = torch.from_numpy(fields.astype(np.int32)).to(dev)
    for capacity in (1, int(counts.sum()), int(counts.sum()) + 999):
        got = segment_expand_offsets(fields, capacity)
        assert torch.equal(got, segment_expand_offsets_plain(fields, capacity))
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
    want = segment_sum_cols_plain(cols, keys, S)
    torch.cuda.synchronize()
    assert got.shape == (F, S)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[:, 1::3] == 0)  # empty segments
    assert torch.equal(segment_sum_cols(cols, keys, S), got)
    with pytest.raises(ValueError):  # keys must be int32
        segment_sum_cols(cols, keys.long(), S)


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
