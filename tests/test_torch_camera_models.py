"""PyTorch port: the camera models and pose refinement against the JAX package.

The same seeded numpy inputs go through both packages:

(a) ``apply_lens`` (OpenCV radial/tangential, equidistant fisheye with a
    point on the optical axis), ``_rodrigues`` (zero, Taylor-branch and
    wide angles) and ``apply_pose_delta``: values and gradients; a zero
    delta returns the camera bit for bit, and the JAX camera after its
    delta, carried across as numpy (``convert.camera_from_numpy``), is the
    port's camera after the same delta;
(b) ``project_gaussians`` in UT mode for the pinhole, the distorted
    pinhole, the fisheye, the ortho camera and the rolling shutter at the
    three velocities of tests/test_rolling_shutter.py and at zero, through
    a pose delta: every output and the gradients of the gaussians and of
    the delta; near the camera plane (a dead slot at the camera centre, a
    gaussian closer than the near plane, splats straddling the plane) for
    the cameras whose lens stays finite there; ortho EWA against JAX's
    closed form; a fisheye or rolling camera takes the UT route whatever
    the config says;
(c) a short pose recovery by gradient descent on the port alone, as
    tests/test_pose.py does it for JAX.

The renders (``render_gaussians``) are in tests/test_torch_camera_render.py
and the 2DGS cameras in tests/test_torch_surfel_cameras.py.

Tolerances (ROADMAP's North star): projection outputs within rtol 1e-5 and
atol 1e-5 x max|ref|, as tests/test_torch_sh_projection.py holds EWA;
gradients within 2e-6 of each gradient array's largest magnitude (the
row's scale). The UT's gradients through thin splats' conics carry f32
rounding of that order in either package, so each gradient of the
projection is also taken in float64 by both packages (the JAX package
under ``jax.enable_x64``): the port's float64 gradient must lie within
F64_GRAD_RTOL (1e-12) of the scale of the reference's float64 gradient, and
the port's f32 gradient within 2e-6 of the scale, plus the reference's own
f32 distance from its float64 gradient, of both the reference's f32 and
float64 gradients. (On this scene the reference's f32 sits up to 4.4e-6 of
the scale from its float64 on the fisheye, whose f32 arctan in XLA on the
CPU is off the correctly rounded value on 5.9% of inputs, torch's on 0.02%;
the two float64 gradients agree to 7e-15 of the scale.) Integer radii round
a float up, so a value one f32 step from an integer may round the other
way: such flips are counted, at most MAX_RADII_FLIPS of a scene's lanes and
by one pixel. The gradient of the projection is taken with the cotangent a
render gives it: zero on the lanes the f32 JAX projection keeps, in every
run.
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
from mojosplat_tpu import apply_pose_delta as japply_pose_delta
from mojosplat_tpu.camera import _rodrigues as jrodrigues
from mojosplat_tpu.ops import projection as jproj
from mojosplat_tpu_torch import (
    Camera, RenderConfig, apply_pose_delta, config_from_jax, render_gaussians)
from mojosplat_tpu_torch.camera import _rodrigues
from mojosplat_tpu_torch.convert import camera_from_numpy
from mojosplat_tpu_torch.ops import projection as tproj
from mojosplat_tpu_torch.train import activate, init_gaussians

RTOL = 1e-5
GRAD_RTOL = 2e-6
F64_GRAD_RTOL = 1e-12
MAX_RADII_FLIPS = 1
F32 = np.float32
KEYS = ("means3d", "scales", "quats", "opacities")
# The rolling-shutter velocities of tests/test_rolling_shutter.py, and zero.
RS_VELS = {
    "lateral": [0.0, 0.0, 0.0, 0.3, 0.0, 0.0],
    "yaw": [0.0, 0.12, 0.0, 0.0, 0.0, 0.0],
    "mixed": [0.05, 0.08, 0.02, 0.1, -0.05, 0.2],
    "zero": [0.0] * 6,
}
# Radial/tangential coefficients that keep the OpenCV polynomial monotone
# out to the sigma points of splats straddling the camera plane (see
# test_ut_projection_near_plane).
PINHOLE_DIST = [0.05, 0.0, 1e-3, -2e-3, 0.0]
FISHEYE_DIST = [0.08, -0.01, 0.002, -0.0005, 0.0]  # tests/test_camera_models.py
CAMERAS = {
    "pinhole": dict(),
    "distorted": dict(dist=PINHOLE_DIST),
    "fisheye": dict(camera_model="fisheye", dist=FISHEYE_DIST),
    "ortho": dict(camera_model="ortho", fx=12.0, fy=13.0),
    **{f"rolling-{k}": dict(shutter="rolling", rs_vel=v) for k, v in RS_VELS.items()},
}
DELTA = np.array([0.01, -0.02, 0.015, 0.02, -0.01, 0.03], F32)


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def assert_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * scale, err_msg=err_msg)


def assert_grad_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), err_msg
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale, err_msg=err_msg)


def make_cameras(kind, H=64, W=64):
    """(JAX camera, port camera) turned away from the world axes, from the
    same numpy fields."""
    ang = 0.2
    c, s = np.cos(ang), np.sin(ang)
    fields = dict(R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], F32),
                  T=np.array([0.1, -0.05, 0.0], F32), H=H, W=W, fx=60.0, fy=58.0,
                  cx=W / 2 - 1.0, cy=H / 2 + 1.0)
    fields.update(CAMERAS[kind])
    jcam = JCamera.create(**fields)
    return jcam, camera_from_numpy(jax_camera_fields(jcam), "cpu")


def make_gaussians(n, seed, near=False):
    """Gaussians in front of the camera (z 1.5 to 6), one on the optical
    axis; with ``near``, centres from behind the camera to z = 7, and two
    lanes for the caller to place (a dead slot at the camera centre) or
    keep (one closer than the near plane)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-0.5, 7.0, (n, 1)) if near else rng.uniform(1.5, 6.0, (n, 1))
    means = np.concatenate([rng.normal(0, 0.8, (n, 2)), z], axis=1).astype(F32)
    means[0] = [0.0, 0.0, 3.0]
    if near:
        means[1] = [-0.1, 0.05, 0.0]  # the camera centre: camera z = 0
        means[2] = [0.1, 0.2, 0.05]
    return dict(
        means3d=means,
        scales=rng.normal(-2.3, 0.5, (n, 3)).astype(F32),
        quats=rng.normal(size=(n, 4)).astype(F32),
        opacities=rng.uniform(0.01, 1.0, n).astype(F32),
    )


@functools.partial(jax.jit, static_argnames=("jcfg",))
def jax_projection_grads(m, s, q, o, d, jcam, w0, w1, w2, kept, jcfg):
    """(grads of the means, scales, quats and delta, projection) of the JAX
    package: the loss of ``project_both``, over the lanes ``kept`` (None:
    the lanes this projection keeps). One compile serves every camera of
    one model and shutter (their arrays are arguments)."""
    def loss(m, s, q, d):
        r = jproj.project_gaussians(m, s, q, o, japply_pose_delta(jcam, d), jcfg)
        k = jnp.all(r.radii > 0, axis=1).astype(m.dtype) if kept is None else kept
        return (jnp.sum(r.means2d * w0 * k[:, None]) + jnp.sum(r.conics * w1 * k[:, None])
                + jnp.sum(r.depths * w2 * k)), r
    return jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(m, s, q, d)


def project_both(kind, p, config=None):
    """Project ``p`` through each package's camera after DELTA, with a
    weighted sum of means2d, conics and depths over the lanes the JAX
    package keeps as the loss. Returns (port result, JAX result, port
    grads, JAX grads, port grads in float64, JAX grads in float64), the
    grads of the means, scales, quats and the delta."""
    jcam, cam = make_cameras(kind)
    jcfg = JConfig(projection_mode="ut") if config is None else config
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    n = p["means3d"].shape[0]
    rng = np.random.default_rng(n)
    w = [rng.normal(size=s).astype(F32) for s in ((n, 2), (n, 3), (n,))]

    jgrads, want = jax_projection_grads(
        *(jnp.asarray(p[k]) for k in KEYS), jnp.asarray(DELTA), jcam, *w, None, jcfg=jcfg)
    kept = torch.from_numpy((np.asarray(want.radii) > 0).all(axis=1).astype(F32))
    with jax.enable_x64(True):
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        jcam64 = JCamera.create(**{k: v if isinstance(v, (int, str)) else f64(v)
                                   for k, v in jax_camera_fields(jcam).items()},
                                dtype=jnp.float64)
        jgrads64 = jax.device_get(jax_projection_grads(
            *(f64(p[k]) for k in KEYS), f64(DELTA), jcam64, *map(f64, w), f64(kept.numpy()),
            jcfg=jcfg)[0])

    def port_side(dtype):
        camera = Camera.create(**{k: v for k, v in dataclasses.asdict(cam).items()
                                  if k not in ("camera_model", "shutter")},
                               camera_model=cam.camera_model, shutter=cam.shutter,
                               dtype=dtype, device="cpu")
        leaves = [torch.tensor(p[k], dtype=dtype, requires_grad=True) for k in KEYS[:3]]
        delta = torch.tensor(DELTA, dtype=dtype, requires_grad=True)
        got = tproj.project_gaussians(*leaves, torch.tensor(p["opacities"], dtype=dtype),
                                      apply_pose_delta(camera, delta), cfg)
        wk = [torch.from_numpy(x).to(dtype) * (kept[:, None] if x.ndim == 2 else kept).to(dtype)
              for x in w]
        ((got.means2d * wk[0]).sum() + (got.conics * wk[1]).sum()
         + (got.depths * wk[2]).sum()).backward()
        return got, [t.grad for t in leaves] + [delta.grad]

    got, grads = port_side(torch.float32)
    return got, want, grads, jgrads, port_side(torch.float64)[1], jgrads64


def assert_projection_matches(got, want, grads, jgrads, grads64, jgrads64, kind):
    for name in ("means2d", "conics", "depths", "compensations"):
        assert_close(getattr(got, name).detach(), getattr(want, name), f"{kind} {name}")
    radii, jradii = got.radii.numpy(), np.asarray(want.radii)
    assert got.radii.dtype == torch.int32
    flips = (radii != jradii).any(axis=1)
    assert int(flips.sum()) <= MAX_RADII_FLIPS, (kind, np.where(flips)[0])
    assert np.abs(radii - jradii).max() <= 1, kind
    kept = (jradii > 0).all(axis=1)
    assert 0 < int(kept.sum()), kind
    for i, name in enumerate(("means3d", "scales", "quats", "delta")):
        g, g64 = grads[i].numpy(), grads64[i].numpy()
        jg, jg64 = np.asarray(jgrads[i]), np.asarray(jgrads64[i])
        assert np.isfinite(g).all() and np.isfinite(jg).all(), f"{kind} d {name}"
        scale = float(np.abs(jg64).max())
        err64 = float(np.abs(g64 - jg64).max())
        assert err64 <= F64_GRAD_RTOL * scale, (
            f"{kind} d {name}: float64 {err64:.3e} from the reference's, scale {scale:.3e}")
        ref_err = float(np.abs(jg - jg64).max())
        for other, what in ((jg, "the reference's"), (jg64, "the reference's float64")):
            err = float(np.abs(g - other).max())
            assert err <= GRAD_RTOL * scale + ref_err, (
                f"{kind} d {name}: {err:.3e} from {what}, scale {scale:.3e}, the reference's "
                f"own f32 error {ref_err:.3e}")


def test_apply_lens_matches():
    rng = np.random.default_rng(0)
    xn = np.concatenate([[0.0, 1e-7], rng.uniform(-0.8, 0.8, 62)]).astype(F32)
    yn = np.concatenate([[0.0, -2e-7], rng.uniform(-0.6, 0.6, 62)]).astype(F32)
    wx, wy = rng.normal(size=(2, 64)).astype(F32)
    dists = {"pinhole": [0.1, -0.05, 1e-3, -2e-3, 0.02], "fisheye": FISHEYE_DIST}
    for model, dist in dists.items():
        jcam = JCamera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=60.0, fy=60.0,
                              cx=32.0, cy=32.0, dist=dist, camera_model=model)
        cam = camera_from_numpy(jax_camera_fields(jcam), "cpu")

        def jloss(x, y):
            xd, yd = jproj.apply_lens(jcam, x, y)
            return jnp.sum(xd * wx + yd * wy), (xd, yd)

        (_, (jxd, jyd)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(xn), jnp.asarray(yn))
        x, y = torch.tensor(xn, requires_grad=True), torch.tensor(yn, requires_grad=True)
        xd, yd = tproj.apply_lens(cam, x, y)
        (xd * torch.from_numpy(wx) + yd * torch.from_numpy(wy)).sum().backward()
        assert_close(xd.detach(), jxd, model)
        assert_close(yd.detach(), jyd, model)
        assert_grad_close(x.grad.numpy(), jg[0], f"{model} d xn")
        assert_grad_close(y.grad.numpy(), jg[1], f"{model} d yn")
    # Zero coefficients are the ideal pinhole, bit for bit.
    cam0 = Camera.create(R=np.eye(3), T=np.zeros(3), H=8, W=8, fx=1.0, fy=1.0, cx=4.0,
                         cy=4.0, device="cpu")
    xd, yd = tproj.apply_lens(cam0, torch.from_numpy(xn), torch.from_numpy(yn))
    assert torch.equal(xd, torch.from_numpy(xn)) and torch.equal(yd, torch.from_numpy(yn))


def test_rodrigues_matches():
    rng = np.random.default_rng(1)
    omegas = np.concatenate([np.zeros((1, 3)), [[1e-7, -2e-7, 5e-8]],
                             [[1e-5, -2e-5, 5e-6]], rng.normal(0, 0.7, (5, 3))]).astype(F32)
    w = rng.normal(size=(8, 3, 3)).astype(F32)
    jg, want = jax.jit(jax.grad(lambda o: (jnp.sum(jrodrigues(o) * w), jrodrigues(o)),
                                has_aux=True))(jnp.asarray(omegas))
    om = torch.tensor(omegas, requires_grad=True)
    got = _rodrigues(om)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.equal(got[0].detach(), torch.eye(3))  # the zero rotation, exactly
    assert_grad_close(om.grad.numpy(), jg, "d omega")  # finite at zero too


def test_apply_pose_delta_matches():
    rng = np.random.default_rng(2)
    jcam, cam = make_cameras("rolling-mixed")
    # A zero delta returns the camera bit for bit, with finite gradients.
    zero = torch.zeros(6, requires_grad=True)
    same = apply_pose_delta(cam, zero)
    assert torch.equal(same.R, cam.R) and torch.equal(same.T, cam.T)
    (same.R.sum() + same.T.sum()).backward()
    assert torch.isfinite(zero.grad).all()
    # A delta: the same camera as the JAX package's, and the same gradient.
    delta = rng.normal(0, 0.2, 6).astype(F32)
    wR, wT = rng.normal(size=(3, 3)).astype(F32), rng.normal(size=3).astype(F32)

    @jax.jit
    def jax_side(d):
        def loss(d):
            moved = japply_pose_delta(jcam, d)
            return jnp.sum(moved.R * wR) + jnp.sum(moved.T * wT), moved
        return jax.grad(loss, has_aux=True)(d)

    jg, jmoved = jax_side(jnp.asarray(delta))
    d = torch.tensor(delta, requires_grad=True)
    moved = apply_pose_delta(cam, d)
    carried = camera_from_numpy(jax_camera_fields(jmoved), "cpu")
    for f in dataclasses.fields(Camera):
        a, b = getattr(moved, f.name), getattr(carried, f.name)
        if isinstance(a, (int, str)):
            assert a == b, f.name
        else:
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f.name)
    ((moved.R * torch.from_numpy(wR)).sum() + (moved.T * torch.from_numpy(wT)).sum()).backward()
    assert_grad_close(d.grad.numpy(), jg, "d delta")
    # A batch of two cameras and deltas: each is the single one (to f32
    # rounding: a batched product), the zero delta's bit for bit.
    cams = dataclasses.replace(cam, R=torch.stack([cam.R, cam.R]), T=torch.stack([cam.T, cam.T]))
    both = apply_pose_delta(cams, torch.stack([d.detach(), torch.zeros(6)]))
    torch.testing.assert_close(both.R[0], moved.R.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(both.T[0], moved.T.detach(), rtol=0, atol=1e-6)
    assert torch.equal(both.R[1], cam.R) and torch.equal(both.T[1], cam.T)


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_ut_projection_matches(kind):
    p = make_gaussians(64, seed=3)
    assert_projection_matches(*project_both(kind, p), kind)
    if kind in ("fisheye", "rolling-mixed"):
        # Fisheye and rolling cameras take the UT route under an EWA config.
        _, cam = make_cameras(kind)
        args = [torch.from_numpy(p[k]) for k in KEYS] + [cam]
        ewa = tproj.project_gaussians(*args, RenderConfig())
        ut = tproj.project_gaussians(*args, RenderConfig(projection_mode="ut"))
        assert torch.equal(ewa.means2d, ut.means2d) and torch.equal(ewa.conics, ut.conics)


@pytest.mark.parametrize("kind", ["pinhole", "fisheye", "ortho", "rolling-mixed"])
def test_ut_projection_near_plane(kind):
    """Sigma points behind the camera and the dummy lanes: the same outputs,
    culls and finite gradients. (With the distorted pinhole the OpenCV
    polynomial of a straddling splat's far sigma points overflows f32 in
    the reference; ROADMAP Queue C.)"""
    p = make_gaussians(64, seed=4, near=True)
    jcam = japply_pose_delta(make_cameras(kind)[0], jnp.asarray(DELTA))
    p["means3d"][1] = -np.asarray(jcam.T) @ np.asarray(jcam.R)  # the camera centre
    out = project_both(kind, p)
    assert_projection_matches(*out, kind)
    assert bool((out[0].radii[1] == 0).all())
    assert int((out[0].radii == 0).all(dim=1).sum()) >= 3  # the scene culls lanes


def test_ortho_ewa_matches_closed_form():
    """Ortho EWA (exact: the map is affine) against JAX's closed form, and
    the centres against u = fx x + cx, v = fy y + cy."""
    p = make_gaussians(64, seed=5)
    assert_projection_matches(*project_both("ortho", p, config=JConfig()), "ortho ewa")
    jcam, cam = make_cameras("ortho")
    pts = np.array([[0.5, -0.4, 2.0], [0.5, -0.4, 9.0], [0.0, 0.0, 5.0]], F32)
    res = tproj.project_gaussians(torch.from_numpy(pts), torch.full((3, 3), -7.0),
                                  torch.tensor([[1.0, 0, 0, 0]] * 3), torch.full((3,), 0.9),
                                  dataclasses.replace(cam, R=torch.eye(3), T=torch.zeros(3)))
    want_uv = np.stack([12.0 * pts[:, 0] + cam.cx.item(), 13.0 * pts[:, 1] + cam.cy.item()], -1)
    np.testing.assert_allclose(res.means2d.numpy(), want_uv, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res.conics[0].numpy(), res.conics[1].numpy())
    np.testing.assert_array_equal(res.depths.numpy(), pts[:, 2])


def test_pose_recovery_by_gradient_descent():
    """tests/test_pose.py's recovery on the port: render a target with the
    true camera, start from a perturbed one, and optimise only the se(3)
    delta with Adam; it must undo most of the perturbation."""
    gen = torch.Generator().manual_seed(3)
    p = activate(init_gaussians(40, position_scale=0.8, generator=gen, device="cpu"))
    p["means3d"] = p["means3d"] + torch.tensor([0.0, 0.0, 3.0])
    cfg = RenderConfig(tile_capacity=64, chunk_size=32)
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=48, W=48, fx=40.0, fy=40.0, cx=24.0,
                        cy=24.0, device="cpu")
    args = [p[k] for k in ("means3d", "scales", "quats", "opacities", "features")]
    with torch.no_grad():
        target = render_gaussians(*args, cam, config=cfg)
    true_pert = torch.tensor([0.01, -0.015, 0.008, 0.02, -0.01, 0.015])
    cam_bad = apply_pose_delta(cam, true_pert)
    d = torch.zeros(6, requires_grad=True)
    opt = torch.optim.Adam([d], lr=3e-3)

    def loss_fn():
        return torch.mean((render_gaussians(*args, apply_pose_delta(cam_bad, d), config=cfg)
                           - target) ** 2)

    with torch.no_grad():
        loss0 = float(loss_fn())
    for _ in range(80):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        assert torch.isfinite(d.grad).all()
        opt.step()
    with torch.no_grad():
        assert float(loss_fn()) < 0.25 * loss0
        cam_rec = apply_pose_delta(cam_bad, d)

    def rot_err(c):
        cos = (torch.trace(c.R @ cam.R.T) - 1) / 2
        return float(torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0))))

    assert rot_err(cam_rec) < 0.7 * rot_err(cam_bad)
    assert (float(torch.linalg.norm(cam_rec.T - cam.T))
            < 0.7 * float(torch.linalg.norm(cam_bad.T - cam.T)))


def test_public_projection_helpers_match():
    """quat_to_rotmat, quat_scale_to_covar, world_to_cam and persp_proj
    (the reference's (N, 3, 3) forms) against JAX's."""
    p = make_gaussians(64, seed=6, near=True)
    jcam, cam = make_cameras("pinhole")
    quats, scales = p["quats"], np.exp(p["scales"])
    t = torch.from_numpy
    assert_close(tproj.quat_to_rotmat(t(quats)), jproj.quat_to_rotmat(jnp.asarray(quats)))
    covars = tproj.quat_scale_to_covar(t(quats), t(scales))
    assert_close(covars, jproj.quat_scale_to_covar(jnp.asarray(quats), jnp.asarray(scales)))
    got = tproj.world_to_cam(t(p["means3d"]), covars, cam.view_matrix)
    want = jproj.world_to_cam(jnp.asarray(p["means3d"]), jnp.asarray(covars.numpy()),
                              jcam.view_matrix)
    for a, b in zip(got, want):
        assert_close(a, b)
    means_c, covars_c = (np.array(x) for x in want)
    got = tproj.persp_proj(t(means_c), t(covars_c), cam.fx, cam.fy, cam.cx, cam.cy, cam.W,
                           cam.H, cam.near)
    want = jproj.persp_proj(jnp.asarray(means_c), jnp.asarray(covars_c), jcam.fx, jcam.fy,
                            jcam.cx, jcam.cy, jcam.W, jcam.H, jcam.near)
    for a, b in zip(got, want):
        assert_close(a, b)
        assert torch.isfinite(a).all()
