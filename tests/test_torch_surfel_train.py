"""PyTorch port: gradients of the 2DGS surfel render and its training step
against the JAX package.

(a) the committed 2DGS golden gradients on both port routes;
(b) every parameter's gradient on both port routes against ``jax.grad`` of
    the JAX ``"xla"`` route, for the 2DGS training loss of
    tests/test_surfel.py (image, depth, normals and distortion);
(c) ``train_step_surfel`` with SGD against ``jax.value_and_grad`` of the
    single-device reference loss of tests/test_sharding.py (photometric,
    distortion and normal-consistency terms summed over two views);
(d) bitwise-equal gradients across two runs of the ``"cuda"`` route.

Gradients are held to the golden tolerance of tests/test_golden.py: rtol
5e-5 and atol 5e-6 x max|g| of each parameter; the loss within rtol 1e-5.
In (b) the atol is 2e-6, the one tests/test_surfel.py holds the
reference's own two routes to on this loss: its depth and distortion terms
add per-pixel contributions that cancel, and a disk whose gradient cancels
to 1e-3 of the largest carries the f32 summation noise of its terms
(1.2e-6, or 7.5e-6 of the largest gradient, on the torch route).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import train as jtrain
from mojosplat_tpu.surfel import normal_consistency_terms as jterms
from mojosplat_tpu.surfel import render_surfels as jrender
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, render_surfels
from mojosplat_tpu_torch import train as ttrain
from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 5e-5, 5e-6
KEYS = ("means3d", "scales", "quats", "opacities", "features")
F32 = np.float32


def assert_grads_close(got, want, err_msg="", atol=None):
    got, want = np.asarray(got), np.asarray(want)
    if atol is None:
        atol = ATOL * (float(np.abs(want).max()) + 1e-12)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=err_msg)


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_golden_2dgs_gradients(route):
    """tests/golden/render_2dgs.npz's gradients, with the loss and config of
    tests/test_golden.py."""
    with np.load(ROOT / "tests" / "golden" / "render_2dgs.npz") as z:
        golden = {k: z[k] for k in z.files}
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k[3:]: v for k, v in golden.items() if k.startswith("in_")}, "cpu").items()}
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0, cx=32.0,
                        cy=32.0, device="cpu")
    cfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl=route)
    img, *maps = render_surfels(*(leaves[k] for k in KEYS), cam, sh_degree=2,
                                background_color=(0.15, 0.05, 0.25), config=cfg,
                                return_depth=True, return_normals=True, return_distortion=True)
    loss = torch.mean(img**2)
    for m in maps:
        loss = loss + 1e-3 * torch.mean(m**2)
    loss.backward()
    for k in KEYS:
        assert_grads_close(leaves[k].grad.numpy(), golden[f"grad_{k}"], f"{route} {k}")


def scene(seed, n):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    quats = rng.normal(0, 1, (n, 4))
    quats[:6] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]  # edge-on
    return dict(means3d=means.astype(F32), scales=rng.normal(-1.8, 0.3, (n, 2)).astype(F32),
                quats=quats.astype(F32), opacities=rng.uniform(0.3, 0.9, n).astype(F32),
                features=rng.uniform(0, 1, (n, 3)).astype(F32))


def test_render_gradients_match_jax():
    """The 2DGS training loss of tests/test_surfel.py on both routes."""
    p = scene(10, 70)
    jcam = JCamera.create(R=np.eye(3, dtype=F32), T=np.zeros(3, F32), H=64, W=64, fx=100.0,
                          fy=100.0, cx=32.0, cy=32.0)
    jcfg = JConfig(raster_impl="xla", tile_capacity=128, chunk_size=32)
    bg = np.array([0.1, 0.1, 0.1], F32)

    def loss(img, depth, normals, dist, mean):
        return (mean(img**2) + 0.3 * mean(depth**2) + 0.2 * mean(normals * normals)
                + 0.5 * mean(dist))

    def jloss(q):
        out = jrender(*(q[k] for k in KEYS), jcam, config=jcfg, background_color=bg,
                      return_depth=True, return_normals=True, return_distortion=True)
        return loss(*out, jnp.mean)

    want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in p.items()})
    cam = camera_from_numpy(jax_camera_fields(jcam), "cpu")
    for route in ("torch", "cuda"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
        out = render_surfels(*(leaves[k] for k in KEYS), cam, config=cfg, background_color=bg,
                             return_depth=True, return_normals=True, return_distortion=True)
        loss(*out, torch.mean).backward()
        for k in KEYS:
            g = leaves[k].grad.numpy()
            assert np.isfinite(g).all() and np.abs(g).max() > 0, (route, k)
            assert_grads_close(g, np.asarray(want[k]), f"{route} {k}", atol=2e-6)


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_train_step_surfel_matches_jax(route):
    rng = np.random.default_rng(21)
    n, B, H, W = 48, 2, 32, 32
    raw = dict(
        means3d=np.concatenate([rng.normal(0, 0.3, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], 1),
        scales=rng.normal(-1.8, 0.2, (n, 2)), quats=rng.normal(0, 1, (n, 4)),
        opacities_raw=rng.normal(1.0, 0.5, n), features=rng.uniform(0, 1, (n, 3)))
    raw = {k: v.astype(F32) for k, v in raw.items()}
    targets = rng.uniform(0, 1, (B, H, W, 3)).astype(F32)
    Ts = rng.normal(0, 0.1, (B, 3)).astype(F32)
    jcams = [JCamera.create(R=np.eye(3, dtype=F32), T=Ts[i], H=H, W=W, fx=30.0, fy=30.0,
                            cx=16.0, cy=16.0) for i in range(B)]
    jcfg = JConfig(raster_impl="xla", tile_capacity=64, chunk_size=32)
    nw, dw = 0.05, 0.01

    def loss_fn(params):
        """tests/test_sharding.py's single-device reference loss."""
        p = jtrain.activate(params)
        photo = dist = num = den = 0.0
        for i, cam in enumerate(jcams):
            img, depth, normal, d, aux = jrender(
                *(p[k] for k in KEYS), cam, config=jcfg, return_aux=True, return_depth=True,
                return_normals=True, return_distortion=True)
            a, b = jterms(depth, normal, aux.raster.final_transmittance, cam)
            photo = photo + jnp.sum((img - targets[i]) ** 2)
            dist, num, den = dist + jnp.sum(d), num + a, den + b
        return (photo / targets.size + dw * dist / (targets.size // 3)
                + nw * num / jnp.maximum(den, 1.0))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))({k: jnp.asarray(v)
                                                          for k, v in raw.items()})
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, "cpu").items()}
    cams = [camera_from_numpy(jax_camera_fields(c), "cpu") for c in jcams]
    loss = ttrain.train_step_surfel(leaves, torch.optim.SGD(leaves.values(), lr=0.5), cams,
                                    torch.from_numpy(targets), config=cfg, normal_weight=nw,
                                    distortion_weight=dw)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in raw:
        g = leaves[k].grad.numpy()
        assert np.abs(g).max() > 0, k
        assert_grads_close(g, np.asarray(jgrads[k]), f"{route} {k}")
        # SGD moved the leaf by lr * grad.
        np.testing.assert_allclose(leaves[k].detach().numpy(), raw[k] - 0.5 * g, rtol=0,
                                   atol=1e-6 * (1 + np.abs(raw[k]).max()))


def test_cuda_route_gradients_bitwise_deterministic():
    p = params_from_numpy(scene(11, 64), "cpu")
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=32, W=32, fx=40.0, fy=40.0, cx=16.0,
                        cy=16.0, device="cpu")
    cfg = RenderConfig(raster_impl="cuda", tile_capacity=64, chunk_size=32)

    def grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        img, depth, normals, dist = render_surfels(
            *(leaves[k] for k in KEYS), cam, config=cfg, return_depth=True,
            return_normals=True, return_distortion=True)
        ((img**2).mean() + (depth**2).mean() + normals.mean() + dist.mean()).backward()
        return {k: v.grad for k, v in leaves.items()}

    a, b = grads(), grads()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert bool(a[k].abs().sum() > 0), k
