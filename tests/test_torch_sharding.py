"""PyTorch port: the camera-DP x tile-SP 3DGS path of ``parallel/`` in a
gloo world of 4 CPU processes, against the JAX package's single-device
functions.

One world (``torch_parallel_cases.case_sharding``) runs every check once per
module, on the same seeded numpy inputs that the JAX side gets here:
``render_batch_sharded`` on meshes (1, 2), (2, 1) and (2, 2) (both routes
on (2, 2)) against JAX's ``render_gaussians`` per camera at 1e-5, the
blocks against the gathered batch; ``project_gaussians_sharded`` over the
gaussians' rows against JAX's ``project_gaussians`` at 1e-6; one SGD step at
lr 1 of ``train_step_sharded`` on each mesh (also with the MCMC
regulariser) against ``jax.value_and_grad`` of the single-device loss;
ZeRO-1 against the replicated Adam update at 1e-7; and the refusals. The
JAX side runs while the world does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_tpu import Camera, RenderConfig, render_gaussians
from mojosplat_tpu import train as mtrain
from mojosplat_tpu.densify import mcmc_regularization
from mojosplat_tpu.ops.projection import project_gaussians
from torch_parallel_cases import (
    CFG, MESHES, cameras_np, finish_world, gaussians_np, start_world)

JCFG = RenderConfig(**CFG)
H = W = 64
# Gradients (parameter changes at SGD lr 1): the slabs' and ranks' sums
# run in other orders than one device's.
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def jax_camera(c):
    return Camera.create(R=c["R"], T=c["T"], H=c["H"], W=c["W"], fx=c["fx"], fy=c["fy"],
                         cx=c["cx"], cy=c["cy"], near=c["near"], far=c["far"])


def jax_render(p, cam):
    return render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                            p["features"], cam, config=JCFG)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world")
    procs = start_world("sharding", 4, out)
    cams = [jax_camera(c) for c in cameras_np(2, seed=0)]
    targets = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (2, H, W, 3)),
                          jnp.float32)

    def loss_fn(raw):
        q = mtrain.activate(raw)
        imgs = jnp.stack([jax_render(q, c) for c in cams])
        return jnp.sum((imgs - targets) ** 2) / targets.size, imgs

    # One compile gives the renders, the loss and its gradient; the
    # regulariser's gradient adds to it.
    raw = gaussians_np(48, seed=1)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    (loss, imgs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jraw)
    reg, reg_grads = jax.value_and_grad(mcmc_regularization)(jraw)
    ref = dict(raw=raw, render=np.asarray(imgs), sgd=(loss, grads), sgd_mcmc=(
        loss + reg, jax.tree_util.tree_map(lambda a, b: a + b, grads, reg_grads)))
    p64 = mtrain.activate({k: jnp.asarray(v) for k, v in gaussians_np(64, seed=2).items()})
    ref["proj"] = project_gaussians(p64["means3d"], p64["scales"], p64["quats"],
                                    p64["opacities"], cams[0], JCFG)._asdict()
    return finish_world(procs, out), ref


def assemble(results, key, nd, nt):
    """The full batch from the ranks' blocks (rank d * nt + t holds data
    block d, slab t)."""
    rows = [np.concatenate([results[d * nt + t][key] for t in range(nt)], axis=1)
            for d in range(nd)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_render_batch_sharded_matches_single_device(world, mesh):
    results, ref = world
    nd, nt = mesh
    got = assemble(results, f"block_torch_{nd}x{nt}", nd, nt)
    assert got.shape == (2, H, W, 3)
    np.testing.assert_allclose(got, ref["render"], atol=1e-5, rtol=1e-5)
    # Every rank of the mesh gathers the same full batch.
    for r in range(nd * nt):
        np.testing.assert_array_equal(results[r][f"full_torch_{nd}x{nt}"], got)


def test_render_batch_sharded_cuda_route(world):
    """The kernel route (its plain versions on the CPU) on the (2, 2) mesh."""
    results, ref = world
    got = assemble(results, "block_cuda_2x2", 2, 2)
    np.testing.assert_allclose(got, ref["render"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(results[3]["full_cuda_2x2"], got)


def test_project_gaussians_sharded_matches_single_device(world):
    results, ref = world
    for r in range(4):
        for k, want in ref["proj"].items():
            np.testing.assert_allclose(results[r][f"proj_{k}"], np.asarray(want), atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("tag", [f"sgd_{nd}x{nt}" for nd, nt in MESHES] + ["sgd_mcmc_2x2"])
def test_train_step_sharded_matches_single_device_grad(world, tag):
    """SGD at lr 1: the change of every parameter is the gradient, held to
    ``jax.value_and_grad`` of the single-device loss (Adam's first step
    would hide the gradient's scale)."""
    results, ref = world
    loss, grads = ref["sgd_mcmc" if "mcmc" in tag else "sgd"]
    nd, nt = (int(x) for x in tag.split("_")[-1].split("x"))
    for r in range(nd * nt):
        np.testing.assert_allclose(float(results[r][f"{tag}_loss"]), float(loss), rtol=1e-5)
        for k, g in grads.items():
            change = ref["raw"][k] - results[r][f"{tag}_{k}"]
            np.testing.assert_allclose(change, np.asarray(g), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"rank {r} d {k}")
    if "mcmc" in tag:
        # The regulariser is in the loss: it moved the step.
        assert float(results[0][f"{tag}_loss"]) > float(results[0]["sgd_2x2_loss"])


def test_zero1_matches_replicated_update(world):
    """Two Adam steps with the moments split over the 4 ranks against the
    replicated optimizer: equal within 1e-7, on every rank."""
    results, _ = world
    for r in range(4):
        out = results[r]
        assert abs(float(out["zero1_True_loss"]) - float(out["zero1_False_loss"])) < 1e-7
        for k in ("means3d", "scales", "quats", "opacities_raw", "features"):
            np.testing.assert_allclose(out[f"zero1_True_{k}"], out[f"zero1_False_{k}"],
                                       atol=1e-7, err_msg=f"rank {r} {k}")
        # Each rank's moments hold its 64 / 4 rows.
        assert int(out["zero1_moment_rows"]) == 16


def test_refusals(world):
    results, _ = world
    errors = list(results[0]["errors"])
    assert len(errors) == 5
    # render_batch_sharded, train_step_sharded, train_step_sharded_surfel
    assert all("image height 48 must be divisible by tile-axis size 4" in e
               for e in errors[:3])
    assert "need 8 ranks, have 4" in errors[3]
    assert "zero1 needs N (6)" in errors[4]
