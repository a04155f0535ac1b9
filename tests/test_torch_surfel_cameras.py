"""PyTorch port: the 2DGS surfels through the ortho and fisheye cameras.

The same seeded numpy inputs go through both packages:

(a) the surfel columns (``surfel_alpha_columns``), the kernels' primed
    columns of an ortho camera (z rows (1, 0, 0)) and the per-pixel alphas
    and intersection depths (``_surfel_alphas``) of the ortho and fisheye
    rays;
(b) ``_invert_equidistant``: the inverse of ``apply_lens``'s fisheye map
    (a round trip), equal to the JAX package's, with finite gradients on the
    optical axis;
(c) ortho disks without the maps: the port's "torch" route and its "cuda"
    route (the kernels' plain versions on the CPU) against JAX's "pallas"
    route in interpret mode, as tests/test_camera_models.py holds JAX's
    "xla" route to it;
(d) fisheye and ortho disks with the depth, normal and distortion maps on
    the "torch" route against JAX's "xla" route, with the gradients of the
    means;
(e) the "cuda" route raises ``NotImplementedError`` exactly where JAX's
    "pallas" route does: for the fisheye, and for ortho with the maps.

Tolerances as tests/test_torch_surfel.py states them: columns within 1e-6
(relative for pixel and scene units), renders within 1e-5 absolute (maps
within 1e-5 of their largest value, plus one), gradients at the golden rule
(rtol 5e-5, atol 5e-6 x max|g|).
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
from mojosplat_tpu import surfel as jsurfel
from mojosplat_tpu.ops import projection as jproj
from mojosplat_tpu.ops import surfel_pallas as jpallas
from mojosplat_tpu_torch import config_from_jax, render_surfels
from mojosplat_tpu_torch import surfel
from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from mojosplat_tpu_torch.ops.projection import apply_lens
from mojosplat_tpu_torch.ops.surfel_cuda import primed_surfel_columns

KEYS = ("means3d", "scales", "quats", "opacities", "features")
RTOL, ATOL = 5e-5, 5e-6
F32 = np.float32
FISHEYE_DIST = [0.03, -0.01, 0.004, -0.001, 0.0]  # tests/test_camera_models.py
H, W = 48, 64


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def make_cameras(model):
    """(JAX camera, port camera) turned away from the world axes: ortho at
    14 px per world unit, or a fisheye of about 60 degrees half-width."""
    ang = 0.25
    R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0], [np.sin(ang), 0, np.cos(ang)]], F32)
    f = 14.0 if model == "ortho" else 40.0
    jcam = JCamera.create(R=R, T=np.array([0.1, -0.05, 0.2], F32), H=H, W=W, fx=f, fy=f * 0.95,
                          cx=W / 2 + 1.5, cy=H / 2 - 2.0, camera_model=model,
                          dist=FISHEYE_DIST if model == "fisheye" else None)
    return jcam, camera_from_numpy(jax_camera_fields(jcam), "cpu")


def surfel_scene(seed, n=64):
    """Disks in front of the camera, some edge-on, with RGB features."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.7, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    quats = rng.normal(0, 1, (n, 4))
    quats[:6] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]  # edge-on
    return dict(means3d=means.astype(F32), scales=rng.uniform(-2.5, -1.2, (n, 2)).astype(F32),
                quats=quats.astype(F32), opacities=rng.uniform(0.4, 0.95, n).astype(F32),
                features=rng.uniform(0, 1, (n, 3)).astype(F32))


@pytest.mark.parametrize("model", ["ortho", "fisheye"])
def test_columns_and_alphas_match_jax(model):
    p = surfel_scene(1)
    jcam, cam = make_cameras(model)
    want = jsurfel.surfel_alpha_columns(*(jnp.asarray(p[k]) for k in KEYS[:4]), jcam)
    tp = params_from_numpy(p, "cpu")
    got = surfel.surfel_alpha_columns(*(tp[k] for k in KEYS[:4]), cam)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=f"column {i}")
    cols = [np.array(c) for c in want]
    jprimed = jpallas.primed_surfel_columns([jnp.asarray(c) for c in cols], jcam)
    for i, (a, b) in enumerate(zip(primed_surfel_columns([torch.from_numpy(c) for c in cols],
                                                         cam), jprimed)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=f"primed {i}")
    if model == "ortho":
        assert all(bool((c == v).all()) for c, v in zip(
            primed_surfel_columns(got, cam)[2::3], (1.0, 0.0, 0.0)))
    d = np.array(jsurfel.surfel_alpha_data(*(jnp.asarray(p[k]) for k in KEYS[:4]), jcam))
    rng = np.random.default_rng(3)
    px = (rng.integers(0, W, 300) + 0.5).astype(F32)
    py = (rng.integers(0, H, 300) + 0.5).astype(F32)
    valid = rng.random(64) > 0.1
    cfg = JConfig()
    want_a, want_z = jsurfel._surfel_alphas(jnp.asarray(px), jnp.asarray(py), jnp.asarray(d),
                                            jnp.asarray(valid), jcam, cfg, with_depth=True)
    got_a, got_z = surfel._surfel_alphas(torch.from_numpy(px), torch.from_numpy(py),
                                         torch.from_numpy(d), torch.from_numpy(valid), cam,
                                         config_from_jax(dataclasses.asdict(cfg)),
                                         with_depth=True)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-6)
    assert int((got_a > 0).sum()) > 100
    used = got_a.numpy() > 0
    np.testing.assert_allclose(got_z.numpy()[used], np.asarray(want_z)[used], rtol=1e-6,
                               atol=1e-6)


def test_invert_equidistant_round_trip():
    jcam, cam = make_cameras("fisheye")
    xn = np.concatenate([[0.0], np.linspace(-0.8, 0.8, 9)]).astype(F32)
    yn = np.concatenate([[0.0], np.linspace(-0.6, 0.6, 9)]).astype(F32)
    xd, yd = apply_lens(cam, torch.from_numpy(xn), torch.from_numpy(yn))
    xd, yd = xd.requires_grad_(True), yd.requires_grad_(True)
    xr, yr = surfel._invert_equidistant(cam, xd, yd)
    np.testing.assert_allclose(xr.detach().numpy(), xn, rtol=0, atol=1e-5)
    np.testing.assert_allclose(yr.detach().numpy(), yn, rtol=0, atol=1e-5)
    jxr, jyr = jsurfel._invert_equidistant(jcam, *jproj.apply_lens(jcam, jnp.asarray(xn),
                                                                   jnp.asarray(yn)))
    np.testing.assert_allclose(xr.detach().numpy(), np.asarray(jxr), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(yr.detach().numpy(), np.asarray(jyr), rtol=1e-6, atol=1e-7)
    (xr.sum() + yr.sum()).backward()
    assert torch.isfinite(xd.grad).all() and torch.isfinite(yd.grad).all()  # on the axis too


def test_ortho_without_maps_matches_pallas():
    p = surfel_scene(2)
    jcam, cam = make_cameras("ortho")
    kw = dict(tile_capacity=128, chunk_size=64, max_tile_span=4)
    jcfg = JConfig(**kw, raster_impl="pallas", pallas_chunk=128, pallas_interpret=True)
    want, want_aux = jax.jit(functools.partial(jsurfel.render_surfels, config=jcfg,
                                               return_aux=True))(
        *(jnp.asarray(p[k]) for k in KEYS), jcam)
    tp = params_from_numpy(p, "cpu")
    for route in ("torch", "cuda"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
        with torch.no_grad():
            img, aux = render_surfels(*(tp[k] for k in KEYS), cam, config=cfg, return_aux=True)
        np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=route)
        np.testing.assert_allclose(aux.raster.final_transmittance.numpy(),
                                   np.asarray(want_aux.raster.final_transmittance), rtol=0,
                                   atol=1e-5, err_msg=route)
        for name, value in aux.binning._asdict().items():
            assert int(value) == int(getattr(want_aux.binning, name)), (route, name)
    assert float(np.abs(np.asarray(want)).max()) > 0.01  # the scene is visible


@pytest.mark.parametrize("model", ["ortho", "fisheye"])
def test_maps_match_xla(model):
    p = surfel_scene(3)
    jcam, cam = make_cameras(model)
    jcfg = JConfig(raster_impl="xla", tile_capacity=128, chunk_size=32)
    kw = dict(return_depth=True, return_normals=True, return_distortion=True)
    bg = np.array([0.15, 0.05, 0.2], F32)
    w = np.random.default_rng(4).normal(size=(H, W, 3)).astype(F32)

    @jax.jit
    def jax_side(m):
        def loss(m):
            out = jsurfel.render_surfels(m, *(jnp.asarray(p[k]) for k in KEYS[1:]), jcam,
                                         background_color=bg, config=jcfg, return_aux=True,
                                         **kw)
            img, depth, normal, dist = out[:4]
            return (jnp.sum(img * w) + 1e-2 * jnp.sum(depth) + 1e-2 * jnp.sum(normal)
                    + 1e-2 * jnp.sum(dist)), out
        return jax.grad(loss, has_aux=True)(m)

    jg, want = jax_side(jnp.asarray(p["means3d"]))
    tp = params_from_numpy(p, "cpu")
    tp["means3d"].requires_grad_(True)
    got = render_surfels(*(tp[k] for k in KEYS), cam, background_color=bg,
                         config=config_from_jax(dataclasses.asdict(jcfg)), return_aux=True, **kw)
    img, depth, normal, dist = got[:4]
    (torch.sum(img * torch.from_numpy(w)) + 1e-2 * depth.sum() + 1e-2 * normal.sum()
     + 1e-2 * dist.sum()).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    for name, a, b in zip(("depth", "normal", "distortion"), got[1:4], want[1:4]):
        scale = float(np.abs(np.asarray(b)).max()) + 1.0
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
    aux, jaux = got[-1], want[-1]
    np.testing.assert_allclose(aux.raster.final_transmittance.detach().numpy(),
                               np.asarray(jaux.raster.final_transmittance), rtol=0, atol=1e-5)
    for name, value in aux.binning._asdict().items():
        assert int(value) == int(getattr(jaux.binning, name)), name
    assert float((1.0 - aux.raster.final_transmittance.detach()).max()) > 0.3
    g, jg = tp["means3d"].grad.numpy(), np.asarray(jg)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, jg, rtol=RTOL, atol=ATOL * float(np.abs(jg).max()))


@pytest.mark.parametrize("model,maps,raises", [
    ("ortho", False, False), ("ortho", True, True), ("fisheye", False, True),
    ("fisheye", True, True)])
def test_cuda_route_raises_where_pallas_does(model, maps, raises):
    p = surfel_scene(5, n=8)
    jcam, cam = make_cameras(model)
    kw = dict(return_depth=maps, return_normals=maps, return_distortion=maps)
    jcfg = JConfig(raster_impl="pallas", pallas_interpret=True, tile_capacity=128,
                   pallas_chunk=128)
    tp = params_from_numpy(p, "cpu")
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    if raises:
        with pytest.raises(NotImplementedError):
            jsurfel.render_surfels(*(jnp.asarray(p[k]) for k in KEYS), jcam, config=jcfg, **kw)
        with pytest.raises(NotImplementedError):
            render_surfels(*(tp[k] for k in KEYS), cam, config=cfg, **kw)
    else:
        with torch.no_grad():
            render_surfels(*(tp[k] for k in KEYS), cam, config=cfg, **kw)
    with torch.no_grad():  # the "torch" route takes every camera, with the maps
        render_surfels(*(tp[k] for k in KEYS), cam,
                       config=dataclasses.replace(cfg, raster_impl="torch"), **kw)
