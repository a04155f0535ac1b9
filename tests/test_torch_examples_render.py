"""PyTorch port: the render CLIs (``render_sample``, ``orbit_demo``,
``viewer``) and the deterministic pieces of the demos.

``make_cameras`` (train_demo), ``orbit_camera`` and ``init_surfels``'
arithmetic on given draws against the reference's functions to 1e-6; each
render CLI's PNG, decoded, equal to ``to_uint8`` of a direct render of the
same scene and view (the viewer for a 3DGS and a surfel scene). Every run
is on the CPU through ``--device cpu --impl torch``.
"""

import io
import math
import os
import runpy

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.examples import orbit_demo, render_sample, train_demo, train_surfel_demo
from mojosplat_tpu_torch.examples import viewer as viewer_cli
from mojosplat_tpu_torch.utils import load_gaussian_ply, to_uint8
from mojosplat_tpu_torch.utils.ply import save_gaussian_ply
from torch_scene_tools_cases import surfel_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--impl", "torch"]


@pytest.fixture(scope="module")
def reference():
    """The reference examples' module globals (imported, not run)."""
    return {name: runpy.run_path(os.path.join(REPO, "examples", name + ".py"))
            for name in ("train_demo", "orbit_demo", "train_surfel_demo")}


def assert_camera_close(got: Camera, want, i=None):
    for k in ("R", "T", "fx", "fy", "cx", "cy", "near", "far"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w if i is None else w[i],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert (got.H, got.W) == (want.H, want.W)


def test_make_cameras_matches_reference(reference):
    want = reference["train_demo"]["make_cameras"](6, 40, 56)
    got = train_demo.make_cameras(6, 40, 56, device="cpu")
    assert len(got) == 6
    for i, cam in enumerate(got):
        assert_camera_close(cam, want, i)


@pytest.mark.parametrize("angle", [0.0, 1.3, 2.0 * math.pi * 17 / 24])
def test_orbit_camera_matches_reference(reference, angle):
    want = reference["orbit_demo"]["orbit_camera"](angle, 5.0, 360, 640, 448.0)
    assert_camera_close(orbit_demo.orbit_camera(angle, 5.0, 360, 640, 448.0, device="cpu"),
                        want)


def test_init_surfels_arithmetic_matches_reference(reference):
    """The port's arithmetic on the reference's own draws from the key."""
    n, scale = 50, 0.8
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    draws = [jax.random.normal(k1, (n, 3)), jax.random.normal(k2, (n, 2)),
             jax.random.normal(k3, (n, 4)), jax.random.normal(k4, (n,)),
             jax.random.uniform(k5, (n, 3))]
    got = train_surfel_demo.surfels_from_draws(
        *(torch.from_numpy(np.array(d)) for d in draws), scale)
    want = reference["train_surfel_demo"]["init_surfels"](key, n, scale)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def read_png(path_or_bytes) -> np.ndarray:
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    return np.asarray(Image.open(src).convert("RGB"))


def test_render_sample_png_equals_direct_render(tmp_path):
    out = str(tmp_path / "demo.png")
    res = render_sample.main(["--gaussians", "400", "--height", "40", "--width", "72",
                              "--out", out] + CPU)
    assert res["renders"] == 2
    p = render_sample.random_scene(400, 42, device="cpu")
    cam = render_sample.demo_camera(40, 72, device="cpu")
    img = render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                           p["features"], cam, background_color=render_sample.BACKGROUND,
                           config=render_sample.demo_config("torch"))
    np.testing.assert_array_equal(read_png(out), to_uint8(img.numpy()))


def test_orbit_frame_equals_direct_render(tmp_path):
    argv = ["--frames", "3", "--gaussians", "300", "--height", "36", "--width", "52",
            "--out-dir", str(tmp_path), "--gif"] + CPU
    res = orbit_demo.main(argv)
    assert len(res["frame_ms"]) == 3 and os.path.exists(tmp_path / "orbit.gif")
    p, sh = orbit_demo.load_scene(orbit_demo.build_parser().parse_args(argv), "cpu")
    for i in (0, 2):
        cam = orbit_demo.orbit_camera(2.0 * math.pi * i / 3, 5.0, 36, 52, 0.7 * 52,
                                      device="cpu")
        img = orbit_demo.render_frame(p, cam, sh, orbit_demo.orbit_config("torch"))
        np.testing.assert_array_equal(read_png(str(tmp_path / f"frame_{i:03d}.png")),
                                      to_uint8(img.numpy()))


def scene_file(tmp_path, family):
    if family == "2dgs":
        p = surfel_sphere()
        p["opacities_raw"] = np.log(p["opacities"] / (1.0 - p["opacities"]))
        del p["opacities"]
    else:
        gen = torch.Generator().manual_seed(5)
        p = mtrain.init_gaussians(300, sh_degree=1, position_scale=1.0, generator=gen,
                                  device="cpu")
    path = str(tmp_path / f"{family}.ply")
    save_gaussian_ply(path, p)
    return path


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_viewer_png_equals_direct_render(tmp_path, family):
    ply = scene_file(tmp_path, family)
    H, W, focal = 36, 60, 50.0
    v = viewer_cli.build_viewer(["--ply", ply, "--height", str(H), "--width", str(W),
                                 "--focal", str(focal)] + CPU)
    assert v.surfels == (family == "2dgs")
    assert "<canvas" in v.page and f'width="{W}"' in v.page
    raw = load_gaussian_ply(ply)
    p = mtrain.activate(params_from_numpy(raw, "cpu"))
    sh = int(round(raw["features"].shape[1] ** 0.5)) - 1
    center = raw["means3d"].mean(axis=0)
    for az, el, r in ((0.0, 0.25, v.radius0), (1.1, -0.3, 1.5 * v.radius0)):
        eye = center + r * np.array([np.sin(az) * np.cos(el), np.sin(el),
                                     np.cos(az) * np.cos(el)])
        R, T = look_at(eye=eye.astype(np.float32), target=center.astype(np.float32),
                       up=[0.0, 1.0, 0.0], device="cpu")
        cam = Camera.create(R=R, T=T, H=H, W=W, fx=focal, fy=focal, cx=W / 2, cy=H / 2,
                            device="cpu")
        prim = render_surfels if family == "2dgs" else render_gaussians
        img = prim(p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
                   sh_degree=sh, background_color=viewer_cli.BACKGROUND,
                   config=RenderConfig(raster_impl="torch", tile_capacity=512, chunk_size=64))
        np.testing.assert_array_equal(read_png(v.png(az, el, r)), to_uint8(img.numpy()))
