"""PyTorch port: RenderConfig and the Camera against the JAX package.

Same numpy inputs go to both packages. Config fields must be equal;
camera matrices agree to 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import look_at as jlook_at
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, look_at
from mojosplat_tpu_torch.convert import camera_from_numpy

ATOL = 1e-6


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert jf.keys() == tf.keys()
    jf["raster_impl"] = "torch"  # the oracle route's name in each package
    assert jf == tf
    assert config_from_jax(dataclasses.asdict(JConfig())) == RenderConfig()


@pytest.mark.parametrize("impl,expected", [("xla", "torch"), ("pallas", "cuda")])
def test_config_from_jax_maps_impl(impl, expected):
    jcfg = JConfig(raster_impl=impl, tile_size=32, max_tile_span=4,
                   tile_capacity=256, pallas_chunk=64)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.raster_impl == expected
    for f in dataclasses.fields(JConfig):
        if f.name != "raster_impl":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name)


def test_config_checks_match():
    for kw in (dict(tile_size=0), dict(tile_capacity=100, chunk_size=64)):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            RenderConfig(**kw)
    with pytest.raises(ValueError):
        config_from_jax({"raster_impl": "mosaic"})


def _random_pose(rng, batch=()):
    q = rng.normal(size=batch + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(batch + (3, 3))
    T = rng.normal(size=batch + (3,))
    return R.astype(np.float32), T.astype(np.float32)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_camera_matrices_match(batch):
    rng = np.random.default_rng(7)
    R, T = _random_pose(rng, batch)
    intr = [rng.uniform(40, 90, size=batch).astype(np.float32) for _ in range(4)]
    jcam = JCamera.create(R=R, T=T, H=48, W=64, fx=intr[0], fy=intr[1],
                          cx=intr[2], cy=intr[3], near=0.2, far=50.0)
    cam = Camera.create(R=R, T=T, H=48, W=64, fx=intr[0], fy=intr[1],
                        cx=intr[2], cy=intr[3], near=0.2, far=50.0, device="cpu")
    for name in ("view_matrix", "K", "position"):
        np.testing.assert_allclose(
            getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)),
            rtol=0, atol=ATOL, err_msg=name,
        )
    assert (cam.H, cam.W) == (jcam.H, jcam.W)
    assert cam.dist.shape == tuple(jcam.dist.shape)


def test_camera_from_numpy_roundtrip():
    rng = np.random.default_rng(3)
    R, T = _random_pose(rng)
    jcam = JCamera.create(R=R, T=T, H=30, W=40, fx=50.0, fy=55.0, cx=20.0,
                          cy=15.0, near=0.3, far=20.0)
    cam = camera_from_numpy(jax_camera_fields(jcam), "cpu")
    for f in dataclasses.fields(jcam):
        want, got = getattr(jcam, f.name), getattr(cam, f.name)
        if isinstance(want, (int, str)):
            assert got == want
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_look_at_matches():
    eye, target, up = [1.0, -2.0, 3.0], [0.0, 0.4, 0.0], [0.0, 1.0, 0.0]
    R, T = look_at(eye, target, up, device="cpu")
    jR, jT = jlook_at(jnp.array(eye), jnp.array(target), jnp.array(up))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=ATOL)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(camera_model="fisheye", dist=[0.08, -0.01, 0.002, -0.0005, 0.0]),
    dict(camera_model="ortho"),
    dict(shutter="rolling", rs_vel=[0.05, 0.08, 0.02, 0.1, -0.05, 0.2])])
def test_unported_cameras_raise(kw):
    """Named for when the port refused these cameras: each now builds, with
    the JAX camera's fields and matrices; an unknown model still raises."""
    rng = np.random.default_rng(11)
    R, T = _random_pose(rng, (2,))
    jcam = JCamera.create(R=R, T=T, H=8, W=12, fx=[1.0, 2.0], fy=1.5, cx=4.0, cy=4.0, **kw)
    cam = Camera.create(R=R, T=T, H=8, W=12, fx=[1.0, 2.0], fy=1.5, cx=4.0, cy=4.0,
                        device="cpu", **kw)
    for f in dataclasses.fields(jcam):
        want, got = getattr(jcam, f.name), getattr(cam, f.name)
        if isinstance(want, (int, str)):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
    for name in ("view_matrix", "K", "position"):
        np.testing.assert_allclose(getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    with pytest.raises(ValueError):
        Camera.create(R=np.eye(3), T=np.zeros(3), H=8, W=8, fx=1.0, fy=1.0,
                      cx=4.0, cy=4.0, device="cpu", camera_model="lens")


def test_camera_tensors_on_requested_device():
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=8, W=8, fx=1.0, fy=1.0,
                        cx=4.0, cy=4.0, device=torch.device("cpu"))
    assert all(t.device == torch.device("cpu") for t in (cam.R, cam.T, cam.fx, cam.dist))
    assert all(t.dtype == torch.float32 for t in (cam.R, cam.T, cam.fx, cam.near))
