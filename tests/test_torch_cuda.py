"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
mojosplat_tpu_torch/csrc/ at first use) and skip elsewhere. They import no
jax and need no conftest, so on a machine without jax run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

B4 and B5 must equal their plain versions exactly; B1 must agree within
1e-5 on all but 0.01% of values and within 5e-3 everywhere (a sequential
f32 product against a chunked cumprod can flip a boundary slot).
"""

import numpy as np
import pytest
import torch

from mojosplat_tpu_torch import RenderConfig
from mojosplat_tpu_torch.ops.expand_cuda import (
    segment_expand_offsets, segment_expand_offsets_plain)
from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles, raster_tiles_plain
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
