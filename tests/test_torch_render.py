"""PyTorch port: the whole forward render against the JAX package.

(a) ``render_gaussians`` on both port routes against the JAX function at SH
    degree 3 with depth and aux: image and transmittance within 1e-5
    absolute, depth within 1e-5 of its scale, counters exactly equal;
(b) the committed 3DGS golden forward on both routes at the golden
    tolerances of tests/test_golden.py;
(c) the trained-scene loader, exactly equal to the JAX package's;
(d) the port imports without jax;
(e) the options ported since the first slice: ``viewport_rows`` renders
    and differentiates on both routes as JAX's "xla" route does (the slab
    within 1e-5, the means' gradient at the golden gradient tolerance);
    ``tight_cull``, ``means2d_offset`` and ``absgrad_sink`` leave the
    forward unchanged, and ``projection_mode="ut"`` renders as JAX's "xla"
    route;
(f) the densification sinks' cotangents on both port routes against JAX's
    "xla" route at the gradient tolerance (rtol 5e-5, atol 5e-6 x max|g|),
    and absgrad against JAX's "pallas" route at that route's own tolerance
    in tests/test_absgrad.py (rtol 2e-3, atol 1e-5).
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
        "import mojosplat_tpu_torch.ops.segsum_cuda, mojosplat_tpu_torch.ops.raster_probe\n"
        "import mojosplat_tpu_torch.densify\n"
        "import mojosplat_tpu_torch.utils.scenes, mojosplat_tpu_torch.utils.compress\n"
        "import mojosplat_tpu_torch.bilagrid, mojosplat_tpu_torch.native\n"
        "import mojosplat_tpu_torch.utils.blender, mojosplat_tpu_torch.utils.checkpoint\n"
        "import mojosplat_tpu_torch.utils.colmap, mojosplat_tpu_torch.utils.image\n"
        "import mojosplat_tpu_torch.utils.ply, mojosplat_tpu_torch.utils.splat\n"
        "import mojosplat_tpu_torch.examples.train_colmap\n"
        "import mojosplat_tpu_torch.examples.eval_colmap\n"
        "assert mojosplat_tpu_torch.native.get_native() is not None\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('mojosplat_tpu.') or m == 'mojosplat_tpu'\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
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
    # viewport_rows: rows [16, 32) of a 32-row camera, against JAX's slab.
    jcam32 = JCamera.create(R=np.eye(3), T=np.zeros(3), H=32, W=16, fx=10.0, fy=10.0,
                            cx=8.0, cy=16.0)
    cam32 = camera_from_numpy(jax_camera_fields(jcam32), "cpu")
    jargs = [jnp.asarray(p[k].numpy()) for k in KEYS]

    def jslab(means3d):
        img = jrender(means3d, *jargs[1:], jcam32, sh_degree=3, viewport_rows=(16, 16))
        return jnp.sum(img), img

    (_, want_slab), want_grad = jax.jit(jax.value_and_grad(jslab, has_aux=True))(jargs[0])
    assert float(np.abs(np.asarray(want_slab)).max()) > 0.05
    for route in ("torch", "cuda"):
        means = p["means3d"].clone().requires_grad_(True)
        got = render_gaussians(means, *args[1:-1], cam32, sh_degree=3,
                               config=RenderConfig(raster_impl=route), viewport_rows=(16, 16))
        assert got.shape == (16, 16, 3)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_slab), rtol=0,
                                   atol=ATOL, err_msg=route)
        got.sum().backward()
        np.testing.assert_allclose(means.grad.numpy(), np.asarray(want_grad), rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_ATOL * float(np.abs(want_grad).max()),
                                   err_msg=f"{route} d means3d")
    with pytest.raises(ValueError, match="multiple of tile_size"):
        render_gaussians(*args, sh_degree=3, viewport_rows=(0, 8))
    # The UT projection, once refused here, renders as JAX's "xla" route.
    jcam = JCamera.create(R=np.eye(3), T=np.zeros(3), H=16, W=16, fx=10.0, fy=10.0, cx=8.0,
                          cy=8.0)
    jcfg = JConfig(projection_mode="ut")
    want = jrender(*(jnp.asarray(p[k].numpy()) for k in KEYS), jcam, sh_degree=3, config=jcfg)
    for route in ("torch", "cuda"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
        np.testing.assert_allclose(render_gaussians(*args, sh_degree=3, config=cfg).numpy(),
                                   np.asarray(want), rtol=0, atol=ATOL, err_msg=route)
    assert float(np.abs(np.asarray(want)).max()) > 0.05
    # The ported options: zero sinks and tight culling leave the image as it
    # was (the culled slots add nothing to any pixel).
    want = render_gaussians(*args, sh_degree=3)
    for kw in (dict(means2d_offset=torch.zeros(8, 2)), dict(absgrad_sink=torch.zeros(8, 2)),
               dict(config=RenderConfig(tight_cull=True, max_tile_span=8))):
        torch.testing.assert_close(render_gaussians(*args, sh_degree=3, **kw), want,
                                   rtol=0, atol=1e-6)
    # Both routes differentiate: the torch route through plain autograd, the
    # cuda route through the blend backward and the gather's adjoint; the
    # sinks take gradients on both.
    grad_means = p["means3d"].clone().requires_grad_(True)
    grad_args = [grad_means] + args[1:]
    for route in ("torch", "cuda"):
        cfg = RenderConfig(raster_impl=route)
        for name in ("means2d_offset", "absgrad_sink"):
            sink = torch.zeros(8, 2, requires_grad=True)
            render_gaussians(*grad_args, sh_degree=3, config=cfg, **{name: sink}).sum().backward()
            assert sink.grad is not None and bool(sink.grad.abs().sum() > 0), (route, name)
            if name == "absgrad_sink":
                assert bool((sink.grad >= 0).all()), route
        grad_means.grad = None
        img = render_gaussians(*grad_args, sh_degree=3, config=cfg)
        img.sum().backward()
        assert grad_means.grad is not None and torch.isfinite(grad_means.grad).all(), route
        assert bool(grad_means.grad.abs().sum() > 0), route


SINK_H, SINK_W = 32, 48


def sink_scene(n, seed):
    """RGB gaussians in front of a 48x32 camera."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.6, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    f32 = np.float32
    return dict(means3d=means.astype(f32), scales=rng.normal(-2.3, 0.5, (n, 3)).astype(f32),
                quats=rng.normal(size=(n, 4)).astype(f32),
                opacities=rng.uniform(0.05, 0.95, n).astype(f32),
                features=rng.uniform(0, 1, (n, 3)).astype(f32))


def assert_close(got, want, err_msg, rtol, atol):
    """Within rtol, and atol x the largest |want|."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * (float(np.abs(want).max()) + 1e-12), err_msg=err_msg)


def test_sinks_match_jax():
    n, H, W = 60, SINK_H, SINK_W
    p = sink_scene(n, 2)
    w = np.random.default_rng(7).normal(size=(H, W, 3)).astype(np.float32)
    cam_kw = dict(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=40.0, fy=40.0, cx=24.0, cy=16.0)
    jcfg = JConfig(tile_capacity=128, chunk_size=64, max_tile_span=4)

    def jgrads(cfg):
        """Both sinks' cotangents from one compile."""
        def loss(offset, sink):
            img = jrender(*(jnp.asarray(p[k]) for k in KEYS), JCamera.create(**cam_kw),
                          config=cfg, means2d_offset=offset, absgrad_sink=sink)
            return jnp.sum(img * w)
        zero = jnp.zeros((n, 2))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(zero, zero)
        return dict(zip(("means2d_offset", "absgrad_sink"), map(np.asarray, grads)))

    jpallas = dataclasses.replace(jcfg, raster_impl="pallas", pallas_chunk=128,
                                  pallas_interpret=True)
    want = jgrads(jcfg)
    want_pallas = jgrads(jpallas)["absgrad_sink"]
    assert_close(want_pallas, want["absgrad_sink"], "pallas vs xla", 2e-3, 1e-5)
    tp = params_from_numpy(p, "cpu")
    for route in ("torch", "cuda"):
        for name in ("means2d_offset", "absgrad_sink"):
            sink = torch.zeros((n, 2), requires_grad=True)
            cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                                      raster_impl=route)
            cam = Camera.create(**cam_kw, device="cpu")
            img = render_gaussians(*(tp[k] for k in KEYS), cam, config=cfg, **{name: sink})
            (img * torch.from_numpy(w)).sum().backward()
            got = sink.grad.numpy()
            assert_close(got, want[name], f"{route} {name}", GOLDEN_RTOL, GOLDEN_ATOL)
            if name == "absgrad_sink":
                assert_close(got, want_pallas, f"{route} vs pallas", 2e-3, 1e-5)
                # absgrad dominates the signed gradient component-wise.
                assert np.all(got >= np.abs(want["means2d_offset"]) - 1e-5)
    assert np.abs(want["absgrad_sink"]).max() > 0
