"""PyTorch port: the whole forward render against the JAX package.

(a) ``render_gaussians`` on both port routes against the JAX function at SH
    degree 3 with depth and aux: image and transmittance within 1e-5
    absolute, depth within 1e-5 of its scale, counters exactly equal;
(b) the committed 3DGS golden forward on both routes at the golden
    tolerances of tests/test_golden.py;
(c) the trained-scene loader, exactly equal to the JAX package's;
(d) the port imports without jax;
(e) what is not ported yet raises ``NotImplementedError``.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import render_gaussians as jrender
from mojosplat_tpu import train as jtrain
from mojosplat_tpu.utils.compress import load_compressed_scene as jload
from mojosplat_tpu_torch import Camera, RenderConfig, config_from_jax, render_gaussians
from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from mojosplat_tpu_torch.train import activate
from mojosplat_tpu_torch.utils.compress import load_compressed_scene
from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
GOLDEN_RTOL, GOLDEN_ATOL = 5e-5, 5e-6
KEYS = ("means3d", "scales", "quats", "opacities", "features")


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def sh3_scene(seed, n=128):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.8, (n, 2)),
                            rng.uniform(2.0, 5.0, (n, 1))], axis=1)
    feats = rng.normal(0, 0.3, (n, 16, 3))
    feats[:, 0] += 0.8
    f32 = np.float32
    return dict(
        means3d=means.astype(f32),
        scales=rng.normal(-2.2, 0.4, (n, 3)).astype(f32),
        quats=rng.normal(size=(n, 4)).astype(f32),
        opacities=rng.uniform(0.1, 0.95, n).astype(f32),
        features=feats.astype(f32),
    )


def test_render_matches_jax_sh3():
    p = sh3_scene(0)
    jcam = JCamera.create(R=np.eye(3), T=np.array([0.05, -0.1, 0.0]), H=48,
                          W=64, fx=55.0, fy=55.0, cx=32.0, cy=24.0)
    jcfg = JConfig(raster_impl="xla", tile_capacity=128, chunk_size=32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jitted = jax.jit(functools.partial(jrender, sh_degree=3, config=jcfg,
                                       return_depth=True, return_aux=True))
    want_img, want_depth, want_aux = jitted(
        *(jnp.asarray(p[k]) for k in KEYS), jcam, background_color=bg)
    tp = params_from_numpy(p, "cpu")
    cam = camera_from_numpy(jax_camera_fields(jcam), "cpu")
    for route in ("torch", "cuda"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                                  raster_impl=route)
        with torch.no_grad():
            img, depth, aux = render_gaussians(
                *(tp[k] for k in KEYS), cam, sh_degree=3, background_color=bg,
                config=cfg, return_depth=True, return_aux=True)
        np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0,
                                   atol=ATOL, err_msg=route)
        scale = float(np.abs(np.asarray(want_depth)).max())
        np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth), rtol=0,
                                   atol=ATOL * scale, err_msg=route)
        np.testing.assert_allclose(
            aux.raster.final_transmittance.numpy(),
            np.asarray(want_aux.raster.final_transmittance), rtol=0, atol=ATOL)
        for name, value in aux.binning._asdict().items():
            assert int(value) == int(getattr(want_aux.binning, name)), (route, name)
        assert int(aux.raster.tile_overflow) == int(want_aux.raster.tile_overflow)
    assert int(aux.binning.num_isects) > 0


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_golden_3dgs_forward(route):
    """tests/golden/render_3dgs.npz with the config of tests/test_golden.py."""
    with np.load(ROOT / "tests" / "golden" / "render_3dgs.npz") as z:
        golden = {k: z[k] for k in z.files}
    p = params_from_numpy({k[3:]: v for k, v in golden.items() if k.startswith("in_")},
                          "cpu")
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0,
                        cx=32.0, cy=32.0, device="cpu")
    cfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl=route)
    with torch.no_grad():
        img, depth = render_gaussians(
            *(p[k] for k in KEYS), cam, sh_degree=2,
            background_color=(0.15, 0.05, 0.25), config=cfg, return_depth=True)
    np.testing.assert_allclose(img.numpy(), golden["image"], rtol=GOLDEN_RTOL,
                               atol=GOLDEN_ATOL)
    depth_atol = GOLDEN_ATOL * (float(np.abs(golden["aux_depth"]).max()) + 1.0)
    np.testing.assert_allclose(depth.numpy(), golden["aux_depth"], rtol=GOLDEN_RTOL,
                               atol=depth_atol)


def test_trained_scene_loader_and_activate_match():
    path = str(ROOT / TRAINED_SCENE)
    want = jload(path)
    got = load_compressed_scene(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    few = {k: v[:1000] for k, v in got.items()}
    act = activate(params_from_numpy(few, "cpu"))
    jact = jtrain.activate({k: jnp.asarray(v) for k, v in few.items()})
    assert act.keys() == jact.keys()
    np.testing.assert_allclose(act["opacities"].numpy(), np.asarray(jact["opacities"]),
                               rtol=1e-6, atol=1e-7)


def test_scene_camera_matches_bench():
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    jcam = bench.scene_camera(1080, 1920)
    cam = scene_camera(1080, 1920, device="cpu")
    for name in ("view_matrix", "K", "position"):
        np.testing.assert_allclose(getattr(cam, name).numpy(),
                                   np.asarray(getattr(jcam, name)), rtol=0, atol=1e-6)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import mojosplat_tpu_torch, mojosplat_tpu_torch.convert\n"
        "import mojosplat_tpu_torch.ops.raster_cuda, mojosplat_tpu_torch.train\n"
        "import mojosplat_tpu_torch.ops.segsum_cuda\n"
        "import mojosplat_tpu_torch.utils.scenes, mojosplat_tpu_torch.utils.compress\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in (ROOT / "mojosplat_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


def test_unported_options_raise():
    p = params_from_numpy(sh3_scene(1, n=8), "cpu")
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=16, W=16, fx=10.0, fy=10.0,
                        cx=8.0, cy=8.0, device="cpu")
    args = [p[k] for k in KEYS] + [cam]
    for kw in (dict(viewport_rows=(0, 16)), dict(means2d_offset=torch.zeros(8, 2)),
               dict(absgrad_sink=torch.zeros(8, 2)),
               dict(config=RenderConfig(tight_cull=True)),
               dict(config=RenderConfig(projection_mode="ut"))):
        with pytest.raises(NotImplementedError):
            render_gaussians(*args, sh_degree=3, **kw)
    # Both routes differentiate: the torch route through plain autograd, the
    # cuda route through the blend backward and the gather's adjoint. The
    # unported options raise there too, with inputs that need grad.
    grad_means = p["means3d"].clone().requires_grad_(True)
    grad_args = [grad_means] + args[1:]
    for route in ("torch", "cuda"):
        cfg = RenderConfig(raster_impl=route)
        for kw in (dict(viewport_rows=(0, 16)), dict(means2d_offset=torch.zeros(8, 2)),
                   dict(absgrad_sink=torch.zeros(8, 2))):
            with pytest.raises(NotImplementedError):
                render_gaussians(*grad_args, sh_degree=3, config=cfg, **kw)
        grad_means.grad = None
        img = render_gaussians(*grad_args, sh_degree=3, config=cfg)
        img.sum().backward()
        assert grad_means.grad is not None and torch.isfinite(grad_means.grad).all(), route
        assert bool(grad_means.grad.abs().sum() > 0), route
