"""PyTorch port: SH colour and the EWA and UT projections against the JAX package.

Same numpy inputs go to both packages. Float outputs agree to rtol 1e-5
with atol 1e-5 * max|ref|; the integer radii are exactly equal in EWA mode,
and in UT mode at most one lane's differs, by one pixel (see
test_unscented_projection_not_ported).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops import projection as jproj
from mojosplat_tpu.ops import sh as jsh
from mojosplat_tpu_torch import config_from_jax
from mojosplat_tpu_torch.convert import camera_from_numpy
from mojosplat_tpu_torch.ops import projection as tproj
from mojosplat_tpu_torch.ops import sh as tsh

RTOL = 1e-5


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=1e-5 * scale, err_msg=err_msg)


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def make_gaussians(n, seed, k=16):
    rng = np.random.default_rng(seed)
    means = np.concatenate([
        rng.normal(0, 1.2, (n, 2)), rng.uniform(-0.5, 7.0, (n, 1))
    ], axis=1).astype(np.float32)
    means[0] = 0.0  # exactly at the camera origin (dead-slot case)
    means[1] = [0.1, 0.2, 0.05]  # in front, closer than the near plane
    return dict(
        means3d=means,
        scales=rng.normal(-2.3, 0.6, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.001, 1.0, n).astype(np.float32),
        features=rng.normal(0, 0.4, (n, k, 3)).astype(np.float32),
    )


def make_cameras(seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-0.3, 0.3, 3)
    cx, sx = np.cos(ang), np.sin(ang)
    Rx = np.array([[1, 0, 0], [0, cx[0], -sx[0]], [0, sx[0], cx[0]]])
    Ry = np.array([[cx[1], 0, sx[1]], [0, 1, 0], [-sx[1], 0, cx[1]]])
    R = (Rx @ Ry).astype(np.float32)
    T = np.array([0.1, -0.2, 0.5], np.float32)
    jcam = JCamera.create(R=R, T=T, H=56, W=64, fx=60.0, fy=62.0, cx=31.0,
                          cy=27.0, near=0.1, far=30.0)
    return jcam, camera_from_numpy(jax_camera_fields(jcam), "cpu")


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_color_matches(degree):
    p = make_gaussians(128, seed=degree)
    jcam, cam = make_cameras(1)
    want = jsh.sh_to_color(jnp.asarray(p["features"]), jnp.asarray(p["means3d"]),
                           jcam.position, degree)
    got = tsh.sh_to_color(torch.from_numpy(p["features"]),
                          torch.from_numpy(p["means3d"]), cam.position, degree)
    assert_close(got, want, f"degree {degree}")


def test_sh_helpers_match():
    p = make_gaussians(64, seed=5)
    feats = p["features"]
    for deg in range(4):
        np.testing.assert_array_equal(
            tsh.mask_sh_bands(torch.from_numpy(feats), deg).numpy(),
            np.asarray(jsh.mask_sh_bands(jnp.asarray(feats), deg)),
        )
        assert tsh.num_sh_bases(deg) == jsh.num_sh_bases(deg)
    rgb = np.random.default_rng(2).uniform(0, 1, (10, 3)).astype(np.float32)
    assert_close(tsh.rgb_to_sh0(torch.from_numpy(rgb)), jsh.rgb_to_sh0(rgb))
    dirs = np.zeros((4, 3), np.float32)  # zero directions stay finite
    assert torch.isfinite(tsh._safe_normalize(torch.from_numpy(dirs))).all()
    with pytest.raises(ValueError):
        tsh.eval_sh(torch.from_numpy(feats[:, :4]), torch.ones(64, 3), 2)
    with pytest.raises(ValueError):
        tsh.eval_sh(torch.from_numpy(feats), torch.ones(64, 3), 4)


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(antialiased=True),
    dict(opacity_aware_radius=False, eps2d=0.2),
])
def test_project_gaussians_matches(cfg_kw):
    p = make_gaussians(128, seed=11)
    jcam, cam = make_cameras(2)
    jcfg = JConfig(**cfg_kw)
    want = jproj.project_gaussians(
        jnp.asarray(p["means3d"]), jnp.asarray(p["scales"]),
        jnp.asarray(p["quats"]), jnp.asarray(p["opacities"]), jcam, jcfg)
    got = tproj.project_gaussians(
        torch.from_numpy(p["means3d"]), torch.from_numpy(p["scales"]),
        torch.from_numpy(p["quats"]), torch.from_numpy(p["opacities"]), cam,
        config_from_jax(dataclasses.asdict(jcfg)))
    for name in ("means2d", "conics", "depths", "compensations"):
        assert_close(getattr(got, name), getattr(want, name), name)
    assert got.radii.dtype == torch.int32
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    # The scene exercises both culled and kept gaussians.
    kept = (got.radii > 0).all(dim=1)
    assert 0 < int(kept.sum()) < 128
    assert torch.isfinite(got.conics).all() and torch.isfinite(got.means2d).all()


def test_unscented_projection_not_ported():
    """Named for when the port refused the UT mode: it now matches JAX's on
    the scene of the EWA test (a dead slot at the origin, a gaussian
    closer than the near plane), with antialiasing. The integer radii may
    flip at the ceil where the two packages' f32 sums differ in the last
    place: at most one lane, by one pixel."""
    p = make_gaussians(128, seed=12)
    jcam, cam = make_cameras(3)
    jcfg = JConfig(projection_mode="ut", antialiased=True)
    want = jproj.project_gaussians(
        *(jnp.asarray(p[k]) for k in ("means3d", "scales", "quats", "opacities")), jcam, jcfg)
    got = tproj.project_gaussians(
        *(torch.from_numpy(p[k]) for k in ("means3d", "scales", "quats", "opacities")),
        cam, config_from_jax(dataclasses.asdict(jcfg)))
    for name in ("means2d", "conics", "depths", "compensations"):
        assert_close(getattr(got, name), getattr(want, name), name)
    flips = (got.radii.numpy() != np.asarray(want.radii)).any(axis=1)
    assert int(flips.sum()) <= 1
    assert np.abs(got.radii.numpy() - np.asarray(want.radii)).max() <= 1
    kept = (got.radii > 0).all(dim=1)
    assert 0 < int(kept.sum()) < 128
