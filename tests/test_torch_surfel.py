"""PyTorch port: the 2DGS surfel forward against the JAX package.

(a) the module functions (``surfel_alpha_columns``,
    ``oriented_normal_columns``, ``primed_surfel_columns``,
    ``_surfel_alphas``, ``backproject_normals_from_depth``,
    ``expected_depth_map``, ``normal_consistency_terms``) on identical
    numpy inputs;
(b) ``render_surfels`` on the ``"torch"`` route against the JAX ``"xla"``
    route, with and without the maps, with SH and RGB features: every
    output and every drop counter;
(c) the committed 2DGS golden forward on both port routes; the
    ``viewport_rows`` slab on both routes against JAX's, with the means'
    gradient (in ``test_unported_options_raise``, which holds the options
    that were once refused);
(d) the plain versions of B6/B7 and B8 against the Pallas kernels sit in
    tests/test_torch_surfel_kernels.py (split off to keep each file under
    30 s on one process).

Tolerances: f32 values that the two packages compute with the same
operations agree within 1e-6 absolute, or 1e-6 relative for values in
pixels or scene units (a pixel coordinate near 60 has an f32 spacing of
3.8e-6). Renders within 1e-5 absolute (depth and distortion within 1e-5 of
the map's largest value, since z^2 ~ 16 there), as tests/test_torch_render.py
holds the 3DGS render. Gradients at the golden rule of tests/test_golden.py
per pdata row: rtol 5e-5, atol 5e-6 x max|g|.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import surfel as jsurfel
from mojosplat_tpu.ops import surfel_pallas as jpallas
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, render_surfels
from mojosplat_tpu_torch import surfel
from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from mojosplat_tpu_torch.ops.surfel_cuda import primed_surfel_columns

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("means3d", "scales", "quats", "opacities", "features")
RTOL, ATOL = 5e-5, 5e-6
F32 = np.float32


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def tilted_camera(H=48, W=64):
    """A camera turned away from the world axes, so every rotation term
    counts."""
    ang = 0.3
    R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0], [np.sin(ang), 0, np.cos(ang)]],
                 F32)
    jcam = JCamera.create(R=R, T=np.array([0.1, -0.05, 0.2], F32), H=H, W=W, fx=70.0,
                          fy=66.0, cx=W / 2 + 1.5, cy=H / 2 - 2.0)
    return jcam, camera_from_numpy(jax_camera_fields(jcam), "cpu")


def surfel_scene(seed, n=120, sh=False):
    """Disks in front of the camera; some edge-on (the filter branch), some
    at the opacity threshold, with SH-3 or RGB features."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    quats = rng.normal(0, 1, (n, 4))
    quats[:10] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]  # edge-on
    opac = rng.uniform(0.3, 0.9, n)
    opac[10:13] = 1.0 / 255.0 + np.array([-1e-6, 0.0, 1e-4])
    if sh:
        feats = rng.normal(0, 0.3, (n, 16, 3))
        feats[:, 0] += 0.8
    else:
        feats = rng.uniform(0, 1, (n, 3))
    return dict(means3d=means.astype(F32), scales=rng.normal(-1.8, 0.3, (n, 2)).astype(F32),
                quats=quats.astype(F32), opacities=opac.astype(F32), features=feats.astype(F32))


def test_surfel_columns_match_jax():
    p = surfel_scene(1)
    jcam, cam = tilted_camera()
    want = jsurfel.surfel_alpha_columns(*(jnp.asarray(p[k]) for k in KEYS[:4]), jcam)
    tp = params_from_numpy(p, "cpu")
    got = surfel.surfel_alpha_columns(*(tp[k] for k in KEYS[:4]), cam)
    assert len(got) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=f"column {i}")
    data = surfel.surfel_alpha_data(*(tp[k] for k in KEYS[:4]), cam)
    assert data.shape == (p["means3d"].shape[0], 12)
    # The normals and the primes, fed the same numpy columns.
    cols = [np.array(c) for c in want]
    tcols = [torch.from_numpy(c) for c in cols]
    for name, a, b in (
            ("normals", surfel.oriented_normal_columns(tcols),
             jsurfel.oriented_normal_columns(cols)),
            ("primes", primed_surfel_columns(tcols, cam),
             jpallas.primed_surfel_columns([jnp.asarray(c) for c in cols], jcam))):
        for i, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {i}")
    assert np.all(np.asarray(surfel.oriented_normal_columns(tcols)[2]) <= 0)


@pytest.mark.parametrize("with_depth", [False, True])
def test_surfel_alphas_match_jax(with_depth):
    p = surfel_scene(2, n=40)
    jcam, cam = tilted_camera()
    d = np.array(jsurfel.surfel_alpha_data(*(jnp.asarray(p[k]) for k in KEYS[:4]), jcam))
    rng = np.random.default_rng(3)
    px = (rng.integers(0, 64, 200) + 0.5).astype(F32)
    py = (rng.integers(0, 48, 200) + 0.5).astype(F32)
    valid = rng.random(40) > 0.1
    cfg = JConfig()
    want = jsurfel._surfel_alphas(jnp.asarray(px), jnp.asarray(py), jnp.asarray(d),
                                  jnp.asarray(valid), jcam, cfg, with_depth=with_depth)
    got = surfel._surfel_alphas(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(d),
                                torch.from_numpy(valid), cam, config_from_jax(
                                    dataclasses.asdict(cfg)), with_depth=with_depth)
    if not with_depth:
        got, want = (got,), (want,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    assert int((got[0] > 0).sum()) > 100
    if with_depth:
        # Where both responses underflow to 0 the hit of a nearly parallel
        # ray is ill-conditioned and unused (alpha 0): compare the rest.
        assert got[1].shape == (200, 40, 2)
        used = got[0].numpy() > 0
        np.testing.assert_allclose(got[1].numpy()[used], np.asarray(want[1])[used], rtol=1e-6,
                                   atol=1e-6)


def test_depth_normal_terms_match_jax():
    rng = np.random.default_rng(4)
    H, W = 24, 20
    jcam, cam = tilted_camera(H, W)
    T = rng.uniform(0, 1, (H, W)).astype(F32)
    T[:4] = 1.0  # uncovered rows
    alpha = 1.0 - T
    depth = (alpha * rng.uniform(2, 3, (H, W))).astype(F32)
    normal = (alpha[..., None] * rng.normal(0, 0.3, (H, W, 3)) + [0, 0, -0.8]).astype(F32)
    ghosts = (rng.uniform(2, 3, W).astype(F32), rng.uniform(2, 3, W).astype(F32))
    t = torch.from_numpy
    for kw in (dict(), dict(row0=8, ghost_rows=ghosts)):
        tkw = {k: (tuple(map(t, v)) if k == "ghost_rows" else v) for k, v in kw.items()}
        want = jsurfel.backproject_normals_from_depth(jnp.asarray(depth), jcam, **kw)
        got = surfel.backproject_normals_from_depth(t(depth), cam, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        want = jsurfel.normal_consistency_terms(depth, normal, T, jcam, **kw)
        got = surfel.normal_consistency_terms(t(depth), t(normal), t(T), cam, **tkw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    want = jsurfel.expected_depth_map(depth, T)
    got = surfel.expected_depth_map(t(depth), t(T))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(
        float(surfel.normal_consistency_loss(t(depth), t(normal), t(T), cam)),
        float(jsurfel.normal_consistency_loss(depth, normal, T, jcam)), rtol=1e-6)


def assert_render_close(got, want, err_msg):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5,
                               err_msg=f"{err_msg} image")
    for name, a, b in zip(("map 1", "map 2", "map 3"), got[1:-1], want[1:-1]):
        scale = float(np.abs(np.asarray(b)).max()) + 1.0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{err_msg} {name}")
    aux, jaux = got[-1], want[-1]
    np.testing.assert_allclose(aux.raster.final_transmittance.numpy(),
                               np.asarray(jaux.raster.final_transmittance), rtol=0, atol=1e-5)
    for name, value in aux.binning._asdict().items():
        assert int(value) == int(getattr(jaux.binning, name)), (err_msg, name)
    assert int(aux.raster.tile_overflow) == int(jaux.raster.tile_overflow), err_msg


@pytest.mark.parametrize("sh,maps", [(False, True), (True, True), (True, False)])
def test_torch_route_matches_jax_xla(sh, maps):
    p = surfel_scene(5, n=150, sh=sh)
    jcam, cam = tilted_camera()
    # tile_capacity 64 is exceeded by a few tiles, so tile_overflow counts.
    jcfg = JConfig(raster_impl="xla", tile_capacity=64, chunk_size=32)
    sh_degree = 3 if sh else None
    bg = np.array([0.15, 0.05, 0.2], F32)
    kw = dict(return_depth=maps, return_normals=maps, return_distortion=maps, return_aux=True)
    want = jax.jit(functools.partial(jsurfel.render_surfels, sh_degree=sh_degree, config=jcfg,
                                     **kw))(*(jnp.asarray(p[k]) for k in KEYS), jcam,
                                            background_color=bg)
    tp = params_from_numpy(p, "cpu")
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    with torch.no_grad():
        got = render_surfels(*(tp[k] for k in KEYS), cam, sh_degree=sh_degree,
                             background_color=bg, config=cfg, **kw)
    assert len(got) == (5 if maps else 2)
    assert_render_close(got, want, f"sh={sh} maps={maps}")
    assert int(got[-1].raster.tile_overflow) > 0 and int(got[-1].binning.num_isects) > 0


def load_golden():
    with np.load(ROOT / "tests" / "golden" / "render_2dgs.npz") as z:
        return {k: z[k] for k in z.files}


def golden_camera():
    return Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0, cx=32.0,
                         cy=32.0, device="cpu")


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_golden_2dgs_forward(route):
    """tests/golden/render_2dgs.npz with the config of tests/test_golden.py."""
    golden = load_golden()
    p = params_from_numpy({k[3:]: v for k, v in golden.items() if k.startswith("in_")}, "cpu")
    cfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl=route)
    with torch.no_grad():
        out = render_surfels(*(p[k] for k in KEYS), golden_camera(), sh_degree=2,
                             background_color=(0.15, 0.05, 0.25), config=cfg,
                             return_depth=True, return_normals=True, return_distortion=True)
    np.testing.assert_allclose(out[0].numpy(), golden["image"], rtol=RTOL, atol=ATOL)
    for name, got in zip(("depth", "normal", "distortion"), out[1:]):
        want = golden[f"aux_{name}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * (float(np.abs(want).max()) + 1.0),
                                   err_msg=f"{route} {name}")


def test_unported_options_raise():
    p = params_from_numpy(surfel_scene(7, n=16), "cpu")
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=16, W=16, fx=10.0, fy=10.0, cx=8.0,
                        cy=8.0, device="cpu")
    args = [p[k] for k in KEYS]
    fisheye = dataclasses.replace(cam, camera_model="fisheye")
    # viewport_rows, once refused: rows [16, 32) of a 32-row camera with the
    # maps, on both routes (the "cuda" route's plain kernels read the
    # slab-shifted primed columns), against JAX's slab on the "xla" route,
    # with the means' gradient of the image and depth.
    jcam32 = JCamera.create(R=np.eye(3), T=np.zeros(3), H=32, W=16, fx=10.0, fy=10.0,
                            cx=8.0, cy=16.0)
    cam32 = camera_from_numpy(jax_camera_fields(jcam32), "cpu")
    jargs = [jnp.asarray(p[k].numpy()) for k in KEYS]
    kw = dict(return_depth=True, return_normals=True, viewport_rows=(16, 16))

    def jslab(means3d):
        img, depth, normal = jsurfel.render_surfels(means3d, *jargs[1:], jcam32,
                                                    config=JConfig(raster_impl="xla"), **kw)
        return jnp.sum(img) + 0.1 * jnp.sum(depth), (img, depth, normal)

    (_, want), want_grad = jax.jit(jax.value_and_grad(jslab, has_aux=True))(jargs[0])
    assert float(np.abs(np.asarray(want[0])).max()) > 0.05
    for route in ("torch", "cuda"):
        means = p["means3d"].clone().requires_grad_(True)
        got = render_surfels(means, *args[1:], cam32, config=RenderConfig(raster_impl=route),
                             **kw)
        assert got[0].shape == (16, 16, 3)
        for name, a, b in zip(("image", "depth", "normals"), got, want):
            scale = float(np.abs(np.asarray(b)).max()) + 1.0
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5 * scale, err_msg=f"{route} {name}")
        (got[0].sum() + 0.1 * got[1].sum()).backward()
        np.testing.assert_allclose(means.grad.numpy(), np.asarray(want_grad), rtol=RTOL,
                                   atol=ATOL * float(np.abs(want_grad).max()),
                                   err_msg=f"{route} d means3d")
    # The fisheye raises on the "cuda" route only, as on JAX's "pallas" route
    # (the kernels make no per-pixel lens inversion); "torch" renders it.
    with pytest.raises(NotImplementedError):
        render_surfels(*args, fisheye, config=RenderConfig(raster_impl="cuda"))
    with torch.no_grad():
        img = render_surfels(*args, fisheye, config=RenderConfig(raster_impl="torch"))
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError):  # the kernels blend rgb only
        render_surfels(*args[:4], torch.zeros(16, 4), cam, config=RenderConfig(raster_impl="cuda"))
