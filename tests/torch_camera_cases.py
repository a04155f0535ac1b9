"""Renders through the camera models: the shared body of
tests/test_torch_camera_render.py (JAX's "xla" route) and
tests/test_torch_camera_render_pallas.py (its "pallas" route in interpret
mode), two files so that each stays under 30 s on one process.

``render_gaussians`` with SH colour on the same seeded numpy inputs: the
port's "torch" route against JAX's "xla" route, and both its routes (the
"cuda" route runs the kernels' plain versions on the CPU) against JAX's
"pallas" route in interpret mode (``tile_capacity=128, pallas_chunk=128``, as
tests/test_camera_models.py renders it), for a distorted pinhole in UT
mode, an ortho camera (EWA) and a rolling-shutter fisheye through a pose
delta. Each compares the image, the transmittance, every drop counter, and
the gradients of the means and of the pose delta.

Tolerances (ROADMAP's North star): images within 1e-5 absolute; gradients
within 2e-6 of each gradient array's largest magnitude (the row's scale),
plus the reference's own f32 error. Both packages also render in float64
(the port's "torch" route, the JAX package's "xla" route under
``jax.enable_x64``): the port's float64 gradients must lie within
F64_GRAD_RTOL of the scale of the reference's float64 gradients, and the
port's f32 gradients within 2e-6 of the scale, plus the reference's own f32
distance from its float64 gradient, of both the reference's f32 and float64
gradients. (Either package's f32 gradients sit up to 6e-6 of the scale from
float64 on these scenes; see tests/test_torch_camera_models.py.)
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import apply_pose_delta as japply_pose_delta
from mojosplat_tpu import render_gaussians as jrender
from mojosplat_tpu_torch import Camera, apply_pose_delta, config_from_jax, render_gaussians

ATOL, GRAD_RTOL, F64_GRAD_RTOL = 1e-5, 2e-6, 1e-12
F32 = np.float32
KEYS = ("means3d", "scales", "quats", "opacities", "features")
H = W = 64
CAMERAS = {
    "distorted-ut": (dict(dist=[0.05, -0.01, 1e-3, -2e-3, 0.002]), dict(projection_mode="ut")),
    "ortho": (dict(camera_model="ortho", fx=14.0, fy=14.0), dict()),
    "rolling-fisheye": (dict(camera_model="fisheye", dist=[0.08, -0.01, 0.002, -0.0005, 0.0],
                             shutter="rolling", rs_vel=[0.05, 0.08, 0.02, 0.1, -0.05, 0.2]),
                        dict()),
}
DELTA = np.array([0.01, -0.02, 0.015, 0.02, -0.01, 0.03], F32)


def jax_camera_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def scene(seed, n=64):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.8, (n, 2)), rng.uniform(2.0, 5.0, (n, 1))], axis=1)
    means[0] = [0.0, 0.0, 3.0]  # on the optical axis
    feats = rng.normal(0, 0.3, (n, 4, 3))
    feats[:, 0] += 0.8
    return dict(
        means3d=means.astype(F32),
        scales=rng.normal(-2.2, 0.4, (n, 3)).astype(F32),
        quats=rng.normal(size=(n, 4)).astype(F32),
        opacities=rng.uniform(0.1, 0.95, n).astype(F32),
        features=feats.astype(F32),
    )


@functools.partial(jax.jit, static_argnames=("jcfg",))
def jax_render_grads(p, delta, jcam, w, jcfg):
    """(d means, d delta), (image, aux) of the JAX render of the weighted
    image sum."""
    def loss(m, d):
        img, aux = jrender(m, *(p[k] for k in KEYS[1:]), japply_pose_delta(jcam, d),
                           sh_degree=1, background_color=jnp.array([0.1, 0.2, 0.3]),
                           config=jcfg, return_aux=True)
        return jnp.sum(img * w), (img, aux)
    return jax.grad(loss, argnums=(0, 1), has_aux=True)(p["means3d"], delta)


def port_render_grads(p, jcam, w, config, dtype):
    """(image, aux, d means, d delta) of the port's render of the weighted
    image sum, in ``dtype``."""
    tp = {k: torch.tensor(v, dtype=dtype, requires_grad=k == "means3d") for k, v in p.items()}
    delta = torch.tensor(DELTA, dtype=dtype, requires_grad=True)
    fields = jax_camera_fields(jcam)
    cam = Camera.create(**{k: v if isinstance(v, (int, str)) else np.array(v)
                           for k, v in fields.items()}, dtype=dtype, device="cpu")
    img, aux = render_gaussians(*(tp[k] for k in KEYS), apply_pose_delta(cam, delta),
                                sh_degree=1, background_color=(0.1, 0.2, 0.3), config=config,
                                return_aux=True)
    (img * torch.from_numpy(w).to(dtype)).sum().backward()
    return img.detach(), aux, tp["means3d"].grad, delta.grad


def check_render(kind, impl):
    """Render the scene through camera ``kind`` on JAX's ``impl`` route and
    the port's routes, and hold the image, the transmittance, the drop
    counters and the gradients to the tolerances above."""
    cam_kw, cfg_kw = CAMERAS[kind]
    p = scene(7)
    jcam = JCamera.create(R=np.eye(3), T=np.array([0.05, -0.1, 0.0]), H=H, W=W, **dict(
        dict(fx=55.0, fy=55.0, cx=32.0, cy=30.0), **cam_kw))
    jcfg = JConfig(raster_impl=impl, tile_capacity=128, chunk_size=32, pallas_chunk=128,
                   pallas_interpret=True, **cfg_kw)
    w = np.random.default_rng(1).normal(size=(H, W, 3)).astype(F32)
    (jg_means, jg_delta), (want, want_aux) = jax_render_grads(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(DELTA), jcam, jnp.asarray(w),
        jcfg=jcfg)
    with jax.enable_x64(True):
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        jcam64 = JCamera.create(**{k: v if isinstance(v, (int, str)) else f64(v)
                                   for k, v in jax_camera_fields(jcam).items()},
                                dtype=jnp.float64)
        jg64 = [np.asarray(g) for g in jax_render_grads(
            {k: f64(v) for k, v in p.items()}, f64(DELTA), jcam64, f64(w),
            jcfg=dataclasses.replace(jcfg, raster_impl="xla"))[0]]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    g64 = port_render_grads(p, jcam, w, dataclasses.replace(cfg, raster_impl="torch"),
                            torch.float64)[2:]
    for name, got, want64 in zip(("means3d", "delta"), g64, jg64):
        err64 = float(np.abs(got.numpy() - want64).max())
        assert err64 <= F64_GRAD_RTOL * float(np.abs(want64).max()), (name, err64)
    # Against "pallas" both port routes; against "xla" the "torch" route.
    for route in ("torch", "cuda") if impl == "pallas" else ("torch",):
        img, aux, g_means, g_delta = port_render_grads(
            p, jcam, w, dataclasses.replace(cfg, raster_impl=route), torch.float32)
        np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=route)
        np.testing.assert_allclose(aux.raster.final_transmittance.detach().numpy(),
                                   np.asarray(want_aux.raster.final_transmittance), rtol=0,
                                   atol=ATOL, err_msg=route)
        for name, value in aux.binning._asdict().items():
            assert int(value) == int(getattr(want_aux.binning, name)), (route, name)
        assert int(aux.binning.num_isects) > 0 and float(img.std()) > 0.05
        for name, got, jg, exact in (("means3d", g_means, jg_means, jg64[0]),
                                     ("delta", g_delta, jg_delta, jg64[1])):
            got, jg = got.numpy(), np.asarray(jg)
            assert np.isfinite(got).all(), (route, name)
            bound = GRAD_RTOL * float(np.abs(exact).max()) + float(np.abs(jg - exact).max())
            for other in (jg, exact):
                assert float(np.abs(got - other).max()) <= bound, (route, name, bound)
