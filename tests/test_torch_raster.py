"""PyTorch port: kernels B5 and B1 (plain versions) and rasterization vs JAX.

B5's plain version must equal ``segment_slice_gather`` (Pallas, interpret
mode) exactly; B1's plain version must agree with ``raster_tiles_pallas``
(interpret mode) to 1e-5 absolute; ``rasterize_gaussians`` on both port
routes must agree with the JAX function to 1e-5 absolute, with the
``tile_overflow`` counter exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops.binning import bin_gaussians_to_tiles as jbin
from mojosplat_tpu.ops.raster_pallas import raster_tiles_pallas
from mojosplat_tpu.ops.rasterization import rasterize_gaussians as jrasterize
from mojosplat_tpu.ops.slice_pallas import segment_slice_gather as jslice
from mojosplat_tpu_torch import config_from_jax
from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
from mojosplat_tpu_torch.ops.raster_cuda import (
    gather_tile_data, raster_tiles, raster_tiles_plain)
from mojosplat_tpu_torch.ops.rasterization import rasterize_gaussians
from mojosplat_tpu_torch.ops.slice_cuda import (
    segment_slice_gather, segment_slice_gather_plain)

ATOL = 1e-5


def test_slice_plain_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    M, cap, n_tiles = 1000, 128, 9
    src = rng.integers(-1, 5000, M).astype(np.int32)
    # Starts include slices that run past the end of src (reads give 0).
    starts = np.array([0, 5, 127, 128, 400, 871, 900, 995, 1000], np.int32)
    want = np.asarray(jslice(jnp.asarray(src), jnp.asarray(starts), cap, interpret=True))
    got = segment_slice_gather_plain(torch.from_numpy(src), torch.from_numpy(starts), cap)
    assert got.shape == (n_tiles * cap,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(
        segment_slice_gather(torch.from_numpy(src), torch.from_numpy(starts), cap), got)


def random_pdata(rng, n_tiles, tw, ts, cap, cp):
    """Slot rows for each tile: centres near the tile, positive-definite
    conics, opacities up to 0.99 so that some pixels stop early."""
    th = n_tiles // tw
    tile = np.repeat(np.arange(n_tiles), cap)
    ox = (tile % tw) * ts
    oy = (tile // tw) * ts
    m = n_tiles * cap
    sx = rng.uniform(0.5, 6.0, m)
    sy = rng.uniform(0.5, 6.0, m)
    rho = rng.uniform(-0.8, 0.8, m)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows = [
        ox + rng.uniform(-4, ts + 4, m),
        oy + rng.uniform(-4, ts + 4, m),
        sy**2 / det, -rho * sx * sy / det, sx**2 / det,
        rng.uniform(0.0, 0.99, m),
    ] + [rng.uniform(0.0, 1.5, m) for _ in range(cp)]
    assert th * tw == n_tiles
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("ts,cp", [(16, 4), (8, 6)])
def test_blend_plain_matches_pallas_kernel(ts, cp):
    rng = np.random.default_rng(ts + cp)
    n_tiles, tw, cap = 6, 3, 128
    pdata = random_pdata(rng, n_tiles, tw, ts, cap, cp)
    counts = np.array([0, 1, 37, 64, 100, 128], np.int32)
    # Two Pallas chunks per tile, so early termination crosses a chunk.
    jcfg = JConfig(tile_size=ts, raster_impl="pallas", pallas_chunk=64,
                   pallas_tiles_per_step=2, pallas_interpret=True, chunk_size=32)
    want = np.asarray(raster_tiles_pallas(jnp.asarray(pdata), jnp.asarray(counts),
                                          ts, tw, jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    got = raster_tiles_plain(torch.from_numpy(pdata), torch.from_numpy(counts), ts, tw, cfg)
    assert got.shape == (n_tiles, cp + 1, ts * ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # Some pixels stopped early and an empty tile keeps T = 1.
    assert float(got[:, cp].min()) < 1e-3
    assert torch.all(got[0, cp] == 1.0) and torch.all(got[0, :cp] == 0.0)
    assert torch.equal(
        raster_tiles(torch.from_numpy(pdata), torch.from_numpy(counts), ts, tw, cfg), got)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never sent to a plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        raster_tiles(torch.empty((10, 128), device=meta),
                     torch.empty((1,), dtype=torch.int32, device=meta), 16, 1,
                     config_from_jax({}))
    with pytest.raises(ValueError):
        segment_slice_gather(torch.empty((8,), dtype=torch.int32, device=meta),
                             torch.empty((1,), dtype=torch.int32, device=meta), 4)


def raster_scene(seed, n):
    rng = np.random.default_rng(seed)
    H, W = 40, 56
    means2d = np.stack([rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n)], -1)
    sx, sy, rho = rng.uniform(2, 9, n), rng.uniform(2, 9, n), rng.uniform(-0.7, 0.7, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    conics = np.stack([sy**2 / det, -rho * sx * sy / det, sx**2 / det], -1)
    radii = np.ceil(3.0 * np.stack([sx, sy], -1)).astype(np.int32)
    radii[rng.random(n) < 0.1] = 0  # culled
    depths = rng.uniform(0.5, 9.0, n)
    colors = rng.uniform(0, 1, (n, 3))
    opac = rng.uniform(0.05, 0.99, n)
    f32 = np.float32
    return (H, W, means2d.astype(f32), conics.astype(f32), colors.astype(f32),
            opac.astype(f32), radii, depths.astype(f32))


@pytest.mark.parametrize("cap", [128, 64])
def test_rasterize_matches_jax(cap):
    """Both port routes against the reference's XLA route (its Pallas route
    is pinned kernel by kernel above)."""
    H, W, means2d, conics, colors, opac, radii, depths = raster_scene(0, 120)
    # tile_capacity 64 holds fewer slots than the busiest tiles have, so
    # both port routes must drop the same slots as the reference; that case
    # also blends 5 tiles at a time (tile_batch), which changes no result.
    jcfg = JConfig(raster_impl="xla", tile_capacity=cap, chunk_size=32,
                   max_tile_span=8, tile_batch=5 if cap == 64 else None)
    bg = np.array([0.2, 0.1, 0.3], np.float32)

    @jax.jit
    def reference(means2d, conics, colors, opac, bg, radii, depths):
        jb = jbin(means2d, radii, depths, H, W, jcfg)
        return jrasterize(means2d, conics, colors, opac, bg, jb, H, W, jcfg)

    want_img, want_aux = reference(means2d, conics, colors, opac, bg, radii, depths)

    cfg = config_from_jax(dataclasses.asdict(jcfg))
    t = torch.from_numpy
    for route in ("torch", "cuda"):
        rcfg = dataclasses.replace(cfg, raster_impl=route)
        tb = bin_gaussians_to_tiles(t(means2d), t(radii), t(depths), H, W, rcfg)
        img, aux = rasterize_gaussians(t(means2d), t(conics), t(colors), t(opac),
                                       t(bg), tb, H, W, rcfg)
        assert img.shape == (H, W, 3)
        np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0,
                                   atol=ATOL, err_msg=route)
        np.testing.assert_allclose(aux.final_transmittance.numpy(),
                                   np.asarray(want_aux.final_transmittance),
                                   rtol=0, atol=ATOL, err_msg=route)
        assert int(aux.tile_overflow) == int(want_aux.tile_overflow)
        assert (int(aux.tile_overflow) > 0) == (cap == 64)


def test_gather_tile_data_layout():
    rng = np.random.default_rng(4)
    n = 12
    means2d = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    conics = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    colors = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    opac = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    ids = torch.tensor([3, -1, 11, 0, 7], dtype=torch.int32)
    pdata = gather_tile_data(means2d, conics, colors, opac, ids)
    assert pdata.shape == (11, 5)
    safe = ids.clamp(0, n - 1).long()
    want = torch.cat([means2d[safe].T, conics[safe].T, opac[safe][None], colors[safe].T])
    assert torch.equal(pdata, want)
    # Fewer than 4 channels are padded with zero rows.
    assert gather_tile_data(means2d, conics, colors[:, :3], opac, ids)[9].abs().sum() == 0
