"""PyTorch port: the gaussian-sharded all-to-all pipeline of ``parallel/``
in a gloo world of 4 CPU processes, against the JAX package's
single-device functions (tests/test_gauss_sharded.py's checks).

One world (``torch_parallel_cases.case_gauss``) per module, on meshes of 2
and 4 ranks and both routes: the routed render against JAX's
``render_gaussians`` at atol 1e-6 and rtol 1e-6; the gradients of the mean
squared error, each rank's shard of them, against ``jax.grad`` at atol
1e-6 and rtol 1e-4; one SGD step at lr 1 of ``train_step_gauss_sharded``
(the parameter change is the gradient); the ``RouteAux`` counters against
JAX's ``bin_gaussians_to_tiles`` on each shard's rows and a numpy count of
each shard's slots past ``route_pair_capacity``, with ``route_overflow`` >
0 on the skewed scene; 8 Adam steps through that overflow; and the
height-divisibility refusals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_tpu import Camera, RenderConfig, render_gaussians
from mojosplat_tpu import train as mtrain
from mojosplat_tpu.ops.binning import bin_gaussians_to_tiles, num_tiles
from mojosplat_tpu.ops.projection import project_gaussians
from mojosplat_tpu.parallel.gauss_sharded import route_pair_capacity
from torch_parallel_cases import (
    GAUSS_BG, GAUSS_CFG, GAUSS_H, GAUSS_W, finish_world, gauss_target_np, gaussians_np,
    skewed_gaussians_np, start_world)

JCFG = RenderConfig(**GAUSS_CFG)
KEYS = ("means3d", "scales", "quats", "opacities_raw", "features")
ROUTES = [(n, impl) for n in (2, 4) for impl in ("torch", "cuda")]


def camera():
    return Camera.create(R=jnp.eye(3), T=jnp.zeros(3), H=GAUSS_H, W=GAUSS_W, fx=80.0,
                         fy=80.0, cx=GAUSS_W / 2, cy=GAUSS_H / 2)


def render(raw, **kw):
    p = mtrain.activate(raw)
    return render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                            p["features"], camera(), config=JCFG, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world")
    procs = start_world("gauss", 4, out)
    ta, tb = jnp.asarray(gauss_target_np(9)), jnp.asarray(gauss_target_np(5))

    def loss_a(raw):
        img = render(raw, background_color=jnp.asarray(GAUSS_BG))
        return jnp.mean((img - ta) ** 2), img

    def loss_b(raw):
        img = render(raw, sh_degree=1)
        return jnp.sum((img - tb) ** 2) / tb.size, img

    ref = {}
    for name, fn, raw in (("a", loss_a, gaussians_np(64, 3)),
                          ("b", loss_b, gaussians_np(64, 4, 1))):
        (loss, img), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            {k: jnp.asarray(v) for k, v in raw.items()})
        ref[name] = dict(raw=raw, loss=float(loss), image=np.asarray(img),
                         grads={k: np.asarray(v) for k, v in grads.items()})

    # The skewed scene binned shard by shard, as each rank bins its rows.
    @jax.jit
    def bin_shard(raw):
        p = mtrain.activate(raw)
        proj = project_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                                 camera(), JCFG)
        b = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, GAUSS_H, GAUSS_W,
                                   JCFG, conics=proj.conics, opacities=p["opacities"])
        return b.aux, b.tile_ids

    skew = skewed_gaussians_np(4096, 3)
    ref["skew"] = [bin_shard({k: jnp.asarray(v[r * 1024:(r + 1) * 1024])
                              for k, v in skew.items()}) for r in range(4)]
    return finish_world(procs, out), ref


@pytest.mark.parametrize("n_dev,impl", ROUTES)
@pytest.mark.parametrize("scene", ["a", "b"])
def test_routed_render_matches_single_device(world, n_dev, impl, scene):
    results, ref = world
    got = np.concatenate([results[r][f"{scene}_{n_dev}_{impl}_slab"] for r in range(n_dev)])
    np.testing.assert_allclose(got, ref[scene]["image"], atol=1e-6, rtol=1e-6)
    if scene == "a":
        for r in range(n_dev):  # the gathered image on every rank
            np.testing.assert_array_equal(results[r][f"a_{n_dev}_{impl}_image"], got)
        num_isects, capacity_overflow, _, route_overflow, _ = results[0][f"a_{n_dev}_{impl}_aux"]
        assert num_isects > 0 and route_overflow == 0 and capacity_overflow == 0


@pytest.mark.parametrize("n_dev,impl", ROUTES)
def test_routed_gradients_match_jax_grad(world, n_dev, impl):
    """The reverse all-to-all hands each rank exactly its rows' gradients."""
    results, ref = world
    for k in KEYS:
        got = np.concatenate([results[r][f"a_{n_dev}_{impl}_grad_{k}"] for r in range(n_dev)])
        np.testing.assert_allclose(got, ref["a"]["grads"][k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)


def test_train_step_gauss_sharded_sgd(world):
    """SGD at lr 1 (Adam's first step would hide the gradient's scale):
    every shard's parameter change is its rows of the single-device
    gradient, and only the loss crosses the mesh."""
    results, ref = world
    b = ref["b"]
    for r in range(4):
        np.testing.assert_allclose(float(results[r]["sgd_loss"]), b["loss"], rtol=1e-6)
        for k in KEYS:
            change = b["raw"][k][r * 16:(r + 1) * 16] - results[r][f"sgd_{k}"]
            np.testing.assert_allclose(change, b["grads"][k][r * 16:(r + 1) * 16], atol=1e-6,
                                       rtol=1e-4, err_msg=f"rank {r} {k}")


def test_route_aux_counters_match_per_shard_binning(world):
    results, ref = world
    th, tw = num_tiles(GAUSS_H, GAUSS_W, JCFG.tile_size)
    per_slab = th // 4 * tw
    cap_pair = route_pair_capacity(1024, 4, JCFG)
    kept = route_overflow = 0
    for r, (aux, tile_ids) in enumerate(ref["skew"]):
        # Each rank's own binning of its rows equals JAX's.
        want = [int(aux.num_isects), int(aux.capacity_overflow), int(aux.span_truncated),
                int(aux.tight_culled)]
        assert list(results[r]["skew_bin_aux"]) == want, r
        ids = np.asarray(tile_ids)
        counts = np.bincount(ids[ids < th * tw] // per_slab, minlength=4)
        route_overflow += int(np.maximum(counts - cap_pair, 0).sum())
        kept += int(aux.num_isects)
    num_isects, capacity_overflow, span_truncated, got_route, _ = results[0]["skew_aux"]
    assert got_route == route_overflow > 0
    assert num_isects == kept - route_overflow
    assert capacity_overflow == sum(int(a.capacity_overflow) for a, _ in ref["skew"])
    assert span_truncated == sum(int(a.span_truncated) for a, _ in ref["skew"])
    for r in range(4):  # mesh-summed: the same on every rank
        assert list(results[r]["skew_aux"]) == list(results[0]["skew_aux"])


def test_trains_through_route_overflow(world):
    """tests/test_gauss_sharded.py's bar: finite parameters, a loss that
    falls steadily, and the overflow reported rather than silent."""
    results, _ = world
    for r in range(4):
        out = results[r]
        losses = out["skew_losses"]
        assert bool(out["skew_finite"]) and np.all(np.isfinite(losses))
        assert losses[-1] < losses[0] * 0.98, losses
        assert losses[-1] == losses.min(), losses
        assert out["skew_trained_aux"][3] > 0  # still overflowing after training
        np.testing.assert_array_equal(losses, results[0]["skew_losses"])


def test_height_divisibility_raises(world):
    results, _ = world
    errors = list(results[0]["errors"])
    assert len(errors) == 2
    assert all("image height 48 must divide into 4 slabs" in e for e in errors)
