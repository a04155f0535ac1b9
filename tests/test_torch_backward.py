"""PyTorch port: the backward of the rasterization against the JAX package.

(a) ``raster_tiles_bwd_plain`` (B2's plain version) against ``jax.vjp`` of
    ``raster_tiles_pallas`` (interpret mode), and ``raster_tiles``'s
    autograd on CPU tensors against it;
(b) ``segment_sum_cols_plain`` (B3's plain version) against
    ``segment_sum_cols`` (interpret mode) at 1, 9 and 18 fields, with empty
    segments and dropped keys, also in its ``perm`` form against JAX on the
    same columns permuted in numpy, and the wrapper's ``out`` rows;
(c) the adjoint of ``gather_tile_data`` (with and without the absgrad
    sink) and of ``gather_surfel_tile_data`` (16 and 18 rows) against the
    JAX gathers' VJPs;
(d) bitwise-equal gradients across two runs of the ``"cuda"`` route.

Tolerance: gradients within rtol 5e-5 and atol 5e-6 x max|g| per row, the
golden tolerance of tests/test_golden.py; the segment sum within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops.raster_pallas import gather_tile_data as jgather
from mojosplat_tpu.ops.raster_pallas import raster_tiles_pallas
from mojosplat_tpu.ops.segsum_pallas import segment_sum_cols as jsegsum
from mojosplat_tpu.ops.surfel_pallas import gather_surfel_tile_data as jgather_surfel
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, render_gaussians
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.ops.raster_cuda import (
    gather_tile_data, raster_tiles, raster_tiles_bwd, raster_tiles_bwd_plain)
from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols, segment_sum_cols_plain
from mojosplat_tpu_torch.ops.surfel_cuda import gather_surfel_tile_data

RTOL, ATOL = 5e-5, 5e-6


def assert_grad_close(got, want, err_msg=""):
    """Golden tolerance, the atol scaled by each row's largest gradient."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    for r in range(want.shape[0]):
        scale = float(np.abs(want[r]).max())
        np.testing.assert_allclose(got[r], want[r], rtol=RTOL, atol=ATOL * (scale + 1e-12),
                                   err_msg=f"{err_msg} row {r}")


def random_pdata(rng, n_tiles, tw, ts, cap, cp):
    """Slot rows near each tile: positive-definite conics, opacities up to
    0.99 so that some pixels stop early."""
    tile = np.repeat(np.arange(n_tiles), cap)
    m = n_tiles * cap
    sx, sy = rng.uniform(0.5, 6.0, m), rng.uniform(0.5, 6.0, m)
    rho = rng.uniform(-0.8, 0.8, m)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows = [
        (tile % tw) * ts + rng.uniform(-4, ts + 4, m),
        (tile // tw) * ts + rng.uniform(-4, ts + 4, m),
        sy**2 / det, -rho * sx * sy / det, sx**2 / det,
        rng.uniform(0.0, 0.99, m),
    ] + [rng.uniform(0.0, 1.5, m) for _ in range(cp)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("ts,cp", [(16, 4), (8, 6)])
def test_blend_bwd_plain_matches_pallas_vjp(ts, cp):
    rng = np.random.default_rng(100 + ts + cp)
    n_tiles, tw, cap = 4, 2, 128
    pdata = random_pdata(rng, n_tiles, tw, ts, cap, cp)
    counts = np.array([0, 37, 100, 128], np.int32)
    gout = rng.normal(size=(n_tiles, cp + 1, ts * ts)).astype(np.float32)
    # Two Pallas chunks per tile, so the transmittance cotangent crosses one.
    jcfg = JConfig(tile_size=ts, raster_impl="pallas", pallas_chunk=64,
                   pallas_tiles_per_step=2, pallas_interpret=True, chunk_size=32)
    _, vjp = jax.vjp(
        lambda pd: raster_tiles_pallas(pd, jnp.asarray(counts), ts, tw, jcfg),
        jnp.asarray(pdata))
    (want,) = vjp(jnp.asarray(gout))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    t = torch.from_numpy
    got = raster_tiles_bwd_plain(t(pdata), t(counts), t(gout), ts, tw, cfg)
    assert got.shape == pdata.shape
    assert_grad_close(got.numpy(), np.asarray(want), f"ts={ts} cp={cp}")
    # Nothing past each tile's count, and the empty tile has no gradient.
    d = got.reshape(6 + cp, n_tiles, cap)
    assert torch.all(d[:, 0] == 0) and torch.all(d[:, 1, 37:] == 0)
    # The wrapper on CPU tensors and raster_tiles' autograd give the same.
    assert torch.equal(raster_tiles_bwd(t(pdata), t(counts), t(gout), None, ts, tw, cfg), got)
    pd = t(pdata).requires_grad_(True)
    (raster_tiles(pd, t(counts), ts, tw, cfg) * t(gout)).sum().backward()
    assert torch.equal(pd.grad, got)


def test_blend_bwd_plain_tile_batch_and_autograd():
    """tile_batch changes no result, and the hand-written adjoint agrees
    with autograd through the plain forward."""
    rng = np.random.default_rng(7)
    ts, cp, n_tiles, tw, cap = 8, 4, 6, 3, 64
    pdata = torch.from_numpy(random_pdata(rng, n_tiles, tw, ts, cap, cp))
    counts = torch.tensor([5, 0, 64, 33, 17, 64], dtype=torch.int32)
    gout = torch.from_numpy(rng.normal(size=(n_tiles, cp + 1, ts * ts)).astype(np.float32))
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=16)
    whole = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg)
    batched = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw,
                                     dataclasses.replace(cfg, tile_batch=4))
    assert torch.equal(whole, batched)
    pd = pdata.clone().requires_grad_(True)
    from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles_plain
    (raster_tiles_plain(pd, counts, ts, tw, cfg) * gout).sum().backward()
    assert_grad_close(whole.numpy(), pd.grad.numpy(), "autograd")


@pytest.mark.parametrize("F", [1, 9, 18])
def test_segment_sum_plain_matches_pallas_kernel(F):
    """F: one field, the 3DGS adjoint's 9 and the 2DGS adjoint's 18. The
    ``perm`` form sums the columns in ``perm``'s order, as the reference's
    sort hands the payload to its segment sum."""
    rng = np.random.default_rng(3)
    M, S = 3000, 700
    # Sorted keys with empty segments and keys equal to and past S (dropped).
    keys = np.sort(np.concatenate([
        rng.choice(np.arange(0, S, 3), M - 60),
        np.full(40, S), np.full(20, S + 5)])).astype(np.int32)
    cols = rng.normal(size=(F, M)).astype(np.float32)
    want = np.asarray(jsegsum(tuple(jnp.asarray(c) for c in cols), jnp.asarray(keys), S,
                              interpret=True))
    got = segment_sum_cols_plain(torch.from_numpy(cols), torch.from_numpy(keys), S)
    assert got.shape == (F, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.all(got[:, 1::3] == 0)  # empty segments
    assert torch.equal(segment_sum_cols(torch.from_numpy(cols), torch.from_numpy(keys), S),
                       got)

    perm = rng.permutation(M)
    unsorted = np.empty_like(cols)
    unsorted[:, perm] = cols  # column perm[i] of ``unsorted`` is sorted row i
    got_p = segment_sum_cols_plain(torch.from_numpy(unsorted), torch.from_numpy(keys), S,
                                   perm=torch.from_numpy(perm))
    assert torch.equal(got_p, got)
    jperm = np.asarray(jsegsum(tuple(jnp.asarray(c) for c in unsorted[:, perm]),
                               jnp.asarray(keys), S, interpret=True))
    np.testing.assert_allclose(got_p.numpy(), jperm, rtol=1e-6, atol=1e-6)
    out = torch.full((F + 2, S), 7.0)
    res = segment_sum_cols(torch.from_numpy(unsorted), torch.from_numpy(keys), S,
                           perm=torch.from_numpy(perm), out=out[1:F + 1])
    assert res.data_ptr() == out[1].data_ptr()
    assert torch.equal(out[1:F + 1], got)
    assert bool((out[0] == 7.0).all() and (out[F + 1] == 7.0).all())


@pytest.mark.parametrize("case", ["3dgs", "3dgs-absgrad", "2dgs", "2dgs-maps"])
def test_gather_adjoint_matches_jax_vjp(case):
    """The adjoint routes each slot's cotangent as the reference does, and
    drops it past each tile's count, where the reference routes only zeros
    (the blend writes none there). The cases: the 3DGS gather (9 of 10 rows
    routed), with the absgrad sink (two more columns, |d x| and |d y|), and
    the surfel gather without and with the maps (15 of 16 rows, 18 of 18)."""
    rng = np.random.default_rng(5)
    n, n_tiles, cap, C = 40, 6, 50, 3
    M = n_tiles * cap
    ids = rng.integers(-1, n, M).astype(np.int32)  # -1: clamped padding ids
    counts = np.array([0, 1, 17, 49, 50, 33], np.int32)
    live = (np.arange(cap)[None, :] < counts[:, None]).reshape(-1)
    if case.startswith("3dgs"):
        arrays = (rng.normal(size=(n, 2)), rng.normal(size=(n, 3)), rng.normal(size=(n, C)),
                  rng.uniform(size=n))
        rows = 6 + 4
        sink = np.zeros((n, 2), np.float32) if case == "3dgs-absgrad" else None

        def jfn(*a):
            return jgather(*a[:4], jnp.asarray(ids), interpret=True,
                           absgrad_sink=None if sink is None else a[4])

        def tfn(*a):
            return gather_tile_data(*a[:4], torch.from_numpy(ids), torch.from_numpy(counts),
                                    absgrad_sink=None if sink is None else a[4])
    else:
        rows = 18 if case == "2dgs-maps" else 16
        arrays = tuple(rng.normal(size=n) for _ in range(rows if rows == 18 else 15))
        sink = None

        def jfn(*a):
            return jgather_surfel(a, jnp.asarray(ids), interpret=True)

        def tfn(*a):
            return gather_surfel_tile_data(a, torch.from_numpy(ids), torch.from_numpy(counts))
    arrays = tuple(np.asarray(a, np.float32) for a in arrays) + (
        () if sink is None else (sink,))
    g = rng.normal(size=(rows, M)).astype(np.float32)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g * live))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    pdata = tfn(*ins)
    assert pdata.shape == (rows, M)
    pdata.backward(torch.from_numpy(g))
    for i, (got, w) in enumerate(zip(ins, want)):
        assert bool(got.grad.abs().sum() > 0), i
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5,
                                   err_msg=f"{case} input {i}")


def test_cuda_route_gradients_bitwise_deterministic():
    rng = np.random.default_rng(11)
    n = 64
    p = params_from_numpy(dict(
        means3d=np.concatenate([rng.normal(0, 0.6, (n, 2)), rng.uniform(2, 4, (n, 1))],
                               1).astype(np.float32),
        scales=rng.normal(-2.0, 0.3, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.9, n).astype(np.float32),
        features=rng.normal(0, 0.3, (n, 4, 3)).astype(np.float32),
    ), "cpu")
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=32, W=32, fx=30.0, fy=30.0,
                        cx=16.0, cy=16.0, device="cpu")
    cfg = RenderConfig(raster_impl="cuda", tile_capacity=64, chunk_size=32)

    def grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        img = render_gaussians(*(leaves[k] for k in
                                 ("means3d", "scales", "quats", "opacities", "features")),
                               cam, sh_degree=1, config=cfg)
        (img**2).mean().backward()
        return {k: v.grad for k, v in leaves.items()}

    a, b = grads(), grads()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert bool(a[k].abs().sum() > 0), k
