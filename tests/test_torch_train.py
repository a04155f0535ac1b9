"""PyTorch port: gradients of the render, losses, optimizers and the train
step against the JAX package.

(a) every parameter's gradient of ``render_gaussians`` on both port routes
    against ``jax.grad`` of the JAX render, on a scene with gaussians behind
    the camera, off screen and at the opacity threshold;
(b) the committed 3DGS golden gradients on both routes;
(c) ``ssim``, ``psnr`` and ``dssim_l1_loss`` against JAX;
(d) Adam and ``selective_adam`` against optax, fed identical numpy
    gradients (Adam's first step moves each element by about lr whatever
    the gradient's size, so two independently computed gradients would
    flip the sign of near-zero elements);
(e) one ``train_step`` against JAX's ``train_step`` with plain SGD.

Gradients are held to the golden tolerance of tests/test_golden.py: rtol
5e-5 and atol 5e-6 x max|g| of each parameter.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import render_gaussians as jrender
from mojosplat_tpu import train as jtrain
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, render_gaussians
from mojosplat_tpu_torch import train as ttrain
from mojosplat_tpu_torch.convert import (
    camera_from_numpy, params_from_numpy, set_grads_from_numpy)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 5e-5, 5e-6
KEYS = ("means3d", "scales", "quats", "opacities", "features")


def assert_grads_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * (scale + 1e-12),
                               err_msg=err_msg)


def edge_scene(seed, n=96):
    """SH-3 gaussians in front of the camera, plus some behind it, some far
    off screen and some at the opacity threshold (1/255) on either side."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.7, (n, 2)), rng.uniform(1.5, 4.5, (n, 1))], 1)
    means[:6, 2] = -rng.uniform(0.5, 2.0, 6)  # behind the camera
    means[6:9, 2] = 0.0  # in the camera plane
    means[9:12, :2] = 40.0  # off screen
    opac = rng.uniform(0.1, 0.95, n)
    opac[12:16] = 1.0 / 255.0 + np.array([-1e-6, 0.0, 1e-6, 1e-4])
    feats = rng.normal(0, 0.3, (n, 16, 3))
    feats[:, 0] += 0.8
    f32 = np.float32
    return dict(means3d=means.astype(f32),
                scales=rng.normal(-2.2, 0.4, (n, 3)).astype(f32),
                quats=rng.normal(size=(n, 4)).astype(f32),
                opacities=opac.astype(f32), features=feats.astype(f32))


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def test_render_gradients_match_jax():
    p = edge_scene(0)
    H, W = 40, 48
    jcam = JCamera.create(R=np.eye(3), T=np.array([0.05, -0.1, 0.0]), H=H, W=W,
                          fx=45.0, fy=45.0, cx=24.0, cy=20.0)
    jcfg = JConfig(raster_impl="xla", tile_capacity=128, chunk_size=32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wimg = np.random.default_rng(1).uniform(-1, 1, (H, W, 3)).astype(np.float32)

    def jloss(params):
        img, depth = jrender(*(params[k] for k in KEYS), jcam, sh_degree=3,
                             background_color=bg, config=jcfg, return_depth=True)
        return jnp.mean(img * wimg) + 1e-3 * jnp.mean(depth**2)

    want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in p.items()})
    cam = camera_from_numpy(jax_camera_fields(jcam), "cpu")
    for route in ("torch", "cuda"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                                  raster_impl=route)
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
        img, depth = render_gaussians(*(leaves[k] for k in KEYS), cam, sh_degree=3,
                                      background_color=bg, config=cfg, return_depth=True)
        (torch.mean(img * torch.from_numpy(wimg)) + 1e-3 * torch.mean(depth**2)).backward()
        for k in KEYS:
            g = leaves[k].grad.numpy()
            assert np.isfinite(g).all(), (route, k)
            assert_grads_close(g, np.asarray(want[k]), f"{route} {k}")
            # Culled gaussians (behind, in the plane, off screen, below the
            # opacity threshold) get exactly zero.
            assert not g[:14].any(), (route, k)


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_golden_gradients(route):
    """tests/golden/render_3dgs.npz's gradients, with the loss and config of
    tests/test_golden.py."""
    with np.load(ROOT / "tests" / "golden" / "render_3dgs.npz") as z:
        golden = {k: z[k] for k in z.files}
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k[3:]: v for k, v in golden.items() if k.startswith("in_")}, "cpu").items()}
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0,
                        cx=32.0, cy=32.0, device="cpu")
    cfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl=route)
    img, depth = render_gaussians(*(leaves[k] for k in KEYS), cam, sh_degree=2,
                                  background_color=(0.15, 0.05, 0.25), config=cfg,
                                  return_depth=True)
    (torch.mean(img**2) + 1e-3 * torch.mean(depth**2)).backward()
    for k in KEYS:
        assert_grads_close(leaves[k].grad.numpy(), golden[f"grad_{k}"], f"{route} {k}")


def test_image_losses_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    a[:, :8, :8] = 0.5  # a flat patch, where SSIM's variance cancels
    b[:, :8, :8] = 0.5
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn, jfn in ((ttrain.ssim, jtrain.ssim), (ttrain.psnr, jtrain.psnr),
                    (ttrain.dssim_l1_loss, jtrain.dssim_l1_loss),
                    (ttrain.l2_image_loss, jtrain.l2_image_loss)):
        jfn = jax.jit(jfn)
        want = float(jfn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(float(fn(ta, tb)), want, rtol=1e-5, err_msg=fn.__name__)
        np.testing.assert_allclose(float(fn(ta[0], tb[0])), float(jfn(a[0], b[0])),
                                   rtol=1e-5, err_msg=fn.__name__)
    # The gradient, with rendered == target on a flat patch (|x| takes the
    # subgradient 1 at 0 there, as jnp.abs does) and on a flat patch that
    # differs, whose variances still cancel.
    for tie in (True, False):
        if not tie:
            b[:, :8, :8] = 0.52
        ga = torch.from_numpy(a).requires_grad_(True)
        ttrain.dssim_l1_loss(ga, torch.from_numpy(b)).backward()
        want = jax.jit(jax.grad(jtrain.dssim_l1_loss))(jnp.asarray(a), jnp.asarray(b))
        assert_grads_close(ga.grad.numpy(), np.asarray(want), f"dssim grad, tie {tie}")


@pytest.mark.parametrize("selective", [False, True])
def test_adam_matches_optax_on_identical_gradients(selective):
    rng = np.random.default_rng(3)
    shapes = dict(means3d=(10, 3), opacities_raw=(10,), features=(10, 4, 3))
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr = 1e-2
    jopt = jtrain.selective_adam(lr) if selective else optax.adam(lr)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params, "cpu").items()}
    topt = (ttrain.selective_adam(leaves.values(), lr=lr) if selective
            else ttrain.make_optimizer(leaves, lr=lr))
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        for g in grads.values():
            g[step::3] = 0.0  # rows with exactly zero gradient
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        set_grads_from_numpy(leaves, grads)
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(leaves[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {step} {k}")
    mu, nu = jstate[0].mu, jstate[0].nu
    for k in shapes:
        state = topt.state[leaves[k]]
        np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(mu[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(nu[k]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_train_step_matches_jax_sgd(route):
    rng = np.random.default_rng(4)
    n, B, H, W = 48, 2, 32, 32
    raw = dict(
        means3d=np.concatenate([rng.normal(0, 0.5, (n, 2)), rng.uniform(2, 4, (n, 1))], 1),
        scales=rng.normal(-2.0, 0.3, (n, 3)), quats=rng.normal(size=(n, 4)),
        opacities_raw=rng.normal(size=n) + 1.0, features=rng.normal(0, 0.3, (n, 4, 3)))
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    Rs = [np.eye(3, dtype=np.float32) for _ in range(B)]
    Ts = rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    targets = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jcfg = JConfig(raster_impl="xla", tile_capacity=64, chunk_size=32)
    jcams = JCamera.create(R=np.stack(Rs), T=Ts, H=H, W=W, fx=np.full(B, 30.0, np.float32),
                           fy=np.full(B, 30.0, np.float32), cx=np.full(B, 16.0, np.float32),
                           cy=np.full(B, 16.0, np.float32), near=np.full(B, 0.1, np.float32),
                           far=np.full(B, 100.0, np.float32))
    lr = 0.5
    opt = optax.sgd(lr)
    state = jtrain.init_train_state({k: jnp.asarray(v) for k, v in raw.items()}, opt)
    jstep = jax.jit(lambda s, c, t: jtrain.train_step(s, c, t, opt, sh_degree=1, config=jcfg))
    new_state, jloss = jstep(state, jcams, jnp.asarray(targets))

    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, "cpu").items()}
    cams = [Camera.create(R=Rs[i], T=Ts[i], H=H, W=W, fx=30.0, fy=30.0, cx=16.0, cy=16.0,
                          device="cpu") for i in range(B)]
    loss = ttrain.train_step(leaves, torch.optim.SGD(leaves.values(), lr=lr), cams,
                             torch.from_numpy(targets), sh_degree=1, config=cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in raw:
        step_t = (leaves[k].detach().numpy() - raw[k]) / -lr
        step_j = (np.asarray(new_state.params[k]) - raw[k]) / -lr
        assert np.abs(step_j).max() > 0, k
        # The update is lr * grad, held at the gradient tolerance plus the
        # rounding of p - lr * grad.
        np.testing.assert_allclose(step_t, step_j, rtol=RTOL,
                                   atol=ATOL * float(np.abs(step_j).max())
                                   + 2 * float(np.abs(raw[k]).max()) * 2**-23 / lr,
                                   err_msg=f"{route} {k}")


def test_init_gaussians_shapes_and_distribution():
    gen = torch.Generator().manual_seed(0)
    p = ttrain.init_gaussians(4000, sh_degree=2, generator=gen, device="cpu")
    assert p["means3d"].shape == (4000, 3) and p["features"].shape == (4000, 9, 3)
    assert torch.allclose(torch.linalg.norm(p["quats"], dim=-1), torch.ones(4000), atol=1e-6)
    assert abs(float(p["means3d"].std()) - 2.0) < 0.1
    assert abs(float(p["scales"].mean()) + 2.0) < 0.05
    assert abs(float(p["opacities_raw"].mean()) - 1.0) < 0.1
    assert torch.all(p["features"][:, 1:] == 0)
    assert float(p["features"][:, 0].min()) >= -0.5 and float(p["features"][:, 0].max()) < 0.5
    rgb = ttrain.init_gaussians(10, generator=gen, device="cpu")["features"]
    assert rgb.shape == (10, 3) and float(rgb.min()) >= 0.0
