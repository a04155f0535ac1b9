"""PyTorch port: tile binning and kernel B4's plain version against JAX.

The same numpy projection outputs go to the JAX ``bin_gaussians_to_tiles``
("xla" route, and "pallas" in interpret mode) and to both port routes
("torch", and "cuda", which runs B4's plain version on CPU tensors).
``gaussian_ids``, ``tile_ids``, ``tile_ranges`` and every ``BinningAux``
counter must be exactly equal, also under capacity overflow and span
truncation.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops.binning import bin_gaussians_to_tiles as jbin
from mojosplat_tpu.ops.expand_pallas import segment_expand_offsets as jexpand
from mojosplat_tpu.ops.projection import project_gaussians as jproject
from mojosplat_tpu_torch import config_from_jax
from mojosplat_tpu_torch.ops import binning as tbin
from mojosplat_tpu_torch.ops.expand_cuda import (
    segment_expand_offsets, segment_expand_offsets_plain)

H, W = 48, 64


def test_expand_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    n = 128
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0  # zero-count gaussians in the middle
    counts[-10:] = 0  # and at the back
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    fields = np.stack([
        offsets,
        rng.integers(0, 1 << 13, n),
        rng.integers(0, 1 << 13, n),
        np.arange(n),
        rng.integers(0, 1 << 20, n),
    ]).astype(np.int32)
    capacity = total + 37
    want = np.asarray(jexpand(jnp.asarray(fields, jnp.float32), capacity,
                              interpret=True))[:, :total]
    got = segment_expand_offsets_plain(torch.from_numpy(fields), capacity)
    assert got.shape == (5, capacity) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, :total].numpy(), want.astype(np.int32))
    # On a CPU tensor the wrapper is the plain version.
    assert torch.equal(segment_expand_offsets(torch.from_numpy(fields), capacity), got)


def projected_scene(seed, n=128, scale_mean=-2.0):
    """JAX projection of a random scene, as numpy (means2d, radii, depths)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 1.5, (n, 2)),
                            rng.uniform(1.0, 6.0, (n, 1))], axis=1)
    cam = JCamera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=60.0,
                         fy=60.0, cx=W / 2, cy=H / 2)
    proj = jproject(
        jnp.asarray(means, jnp.float32),
        jnp.asarray(rng.normal(scale_mean, 0.7, (n, 3)), jnp.float32),
        jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        jnp.asarray(rng.uniform(0.05, 1.0, n), jnp.float32), cam, JConfig())
    means2d = np.array(proj.means2d)
    radii = np.array(proj.radii)
    depths = np.array(proj.depths)
    # Equal depths must keep the original-index order, and a NaN depth on a
    # gaussian that owns slots must still sort before the empty ones.
    depths[10:14] = depths[10]
    live = np.flatnonzero((radii > 0).all(axis=1))
    depths[live[0]] = np.nan
    return means2d, radii, depths


CASES = {
    "plain": (dict(), None, dict()),
    "span_truncated": (dict(max_tile_span=2), None, dict(scale_mean=-1.0)),
    "capacity_overflow": (dict(max_tile_span=6), 400, dict(scale_mean=-1.2)),
    "ts32": (dict(tile_size=32), None, dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_routes_match_jax(case):
    cfg_kw, capacity, scene_kw = CASES[case]
    means2d, radii, depths = projected_scene(seed=len(case), **scene_kw)
    jargs = (jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths))
    targs = (torch.from_numpy(means2d), torch.from_numpy(radii),
             torch.from_numpy(depths), H, W)
    want = {
        impl: jax.jit(functools.partial(
            jbin, img_height=H, img_width=W, capacity=capacity,
            config=JConfig(raster_impl=impl, pallas_interpret=True, **cfg_kw),
        ))(*jargs)
        for impl in ("xla", "pallas")
    }
    for impl in ("xla", "pallas"):
        jcfg = JConfig(raster_impl=impl, **cfg_kw)
        got = tbin.bin_gaussians_to_tiles(
            *targs, config_from_jax(dataclasses.asdict(jcfg)), capacity=capacity)
        for name in ("gaussian_ids", "tile_ids", "tile_ranges"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want[impl], name)),
                err_msg=f"{impl}: {name}")
            assert getattr(got, name).dtype == torch.int32
        for name, value in got.aux._asdict().items():
            assert int(value) == int(getattr(want[impl].aux, name)), (impl, name)
    # Each case must exercise the drop it is named for.
    aux = want["xla"].aux
    if case == "span_truncated":
        assert int(aux.span_truncated) > 0
    if case == "capacity_overflow":
        assert int(aux.capacity_overflow) > 0
        assert int(aux.num_isects) == capacity


def test_binning_empty_scene():
    means2d = np.zeros((5, 2), np.float32)
    radii = np.zeros((5, 2), np.int32)
    depths = np.ones(5, np.float32)
    for impl in ("torch", "cuda"):
        got = tbin.bin_gaussians_to_tiles(
            torch.from_numpy(means2d), torch.from_numpy(radii),
            torch.from_numpy(depths), H, W, tbin.RenderConfig(raster_impl=impl))
        assert (got.gaussian_ids == -1).all()
        assert int(got.aux.num_isects) == 0
        assert (got.tile_ranges == 0).all()


def test_binning_limits_raise():
    t = torch.zeros((4, 2))
    r = torch.ones((4, 2), dtype=torch.int32)
    d = torch.ones(4)
    # tight_cull: its masks hold spans up to 8; without conics (the surfel
    # binning) it changes nothing.
    conics = torch.tensor([[1.0, 0.0, 1.0]]).repeat(4, 1)
    opac = torch.full((4,), 0.5)
    with pytest.raises(ValueError, match="tight_cull"):
        tbin.bin_gaussians_to_tiles(t, r, d, H, W, tbin.RenderConfig(tight_cull=True),
                                    conics=conics, opacities=opac)
    inert = tbin.bin_gaussians_to_tiles(t, r, d, H, W, tbin.RenderConfig(tight_cull=True))
    off = tbin.bin_gaussians_to_tiles(t, r, d, H, W, tbin.RenderConfig())
    assert torch.equal(inert.gaussian_ids, off.gaussian_ids)
    tight = tbin.bin_gaussians_to_tiles(t, r, d, H, W,
                                        tbin.RenderConfig(tight_cull=True, max_tile_span=8),
                                        conics=conics, opacities=opac)
    assert int(tight.aux.num_isects) == 4 and int(tight.aux.tight_culled) == 0
    with pytest.raises(ValueError):
        tbin.bin_gaussians_to_tiles(t, r, d, H, W, tbin.RenderConfig(max_tile_span=256))
    with pytest.raises(ValueError):
        tbin.bin_gaussians_to_tiles(t, r, d, H, W, tbin.RenderConfig(raster_impl="xla"))
    assert tbin.isect_capacity(1000, tbin.RenderConfig()) == 4096
    assert tbin.num_tiles(1080, 1920, 32) == (34, 60)
