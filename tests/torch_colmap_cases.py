"""Synthetic COLMAP captures for the port's IO and CLI tests (a helper
module, no tests).

``write_sparse`` writes a binary sparse model; ``train_capture`` and
``eval_capture`` build the captures of ``tests/test_train_colmap_cli.py``
and ``tests/test_eval.py`` (the same cameras, SfM points and target
clouds), so the two packages' CLIs run on identical files. The files are
written with the port's writers (byte-equal to the JAX package's,
tests/test_torch_io.py); only the default target clouds (``jax_cloud``)
import JAX, so the card tests can write a capture from a numpy cloud
without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mojosplat_tpu_torch.utils.colmap import (qvec_to_rotmat, write_cameras_bin, write_images_bin,
                                              write_points3d_bin)
from mojosplat_tpu_torch.utils.image import save_png
from mojosplat_tpu_torch.utils.ply import save_gaussian_ply

# (COLMAP model id, its parameters) for each camera model the loaders map:
# SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL, OPENCV, OPENCV_FISHEYE,
# FULL_OPENCV, SIMPLE_RADIAL_FISHEYE, RADIAL_FISHEYE.
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, (60.0, 32.0, 24.0)),
    "PINHOLE": (1, (60.0, 58.0, 32.5, 23.5)),
    "SIMPLE_RADIAL": (2, (60.0, 32.0, 24.0, 0.05)),
    "RADIAL": (3, (60.0, 32.0, 24.0, 0.05, -0.01)),
    "OPENCV": (4, (60.0, 58.0, 32.5, 23.5, 0.05, -0.01, 0.001, -0.002)),
    "OPENCV_FISHEYE": (5, (40.0, 41.0, 32.0, 24.0, 0.08, -0.01, 0.002, -0.0005)),
    "FULL_OPENCV": (6, (60.0, 58.0, 32.5, 23.5, 0.05, -0.01, 0.001, -0.002, 0.003,
                        0.0, 0.0, 0.0)),
    "SIMPLE_RADIAL_FISHEYE": (8, (40.0, 32.0, 24.0, 0.08)),
    "RADIAL_FISHEYE": (9, (40.0, 32.0, 24.0, 0.08, -0.01)),
}


def write_sparse(sparse: Path, cameras, views, xyz, rgb, observations: bool) -> None:
    """A binary COLMAP model in ``sparse``, through the port's writers.
    ``cameras``: [(model id, W, H, params)], ids from 1; ``views``: [(name,
    qvec wxyz, tvec, camera id)]; ``xyz`` (P, 3), ``rgb`` (P, 3) uint8. With
    ``observations`` every view observes every point at its pinhole
    projection (fx = params[0]), with a track of one element per point."""
    sparse.mkdir(parents=True, exist_ok=True)
    write_cameras_bin(str(sparse / "cameras.bin"),
                      [(cid, *cam) for cid, cam in enumerate(cameras, start=1)])
    images = []
    for i, (name, q, t, cid) in enumerate(views):
        xys, pids = np.zeros((0, 2)), np.zeros(0, np.int64)
        if observations:
            _, W, H, params = cameras[cid - 1]
            f = params[0]
            pc = xyz @ qvec_to_rotmat(np.asarray(q)).T + np.asarray(t)
            xys = np.stack([f * pc[:, 0] / pc[:, 2] + W / 2, f * pc[:, 1] / pc[:, 2] + H / 2], -1)
            pids = np.arange(1, len(xyz) + 1)
        images.append((i + 1, q, t, cid, name, xys, pids))
    write_images_bin(str(sparse / "images.bin"), images)
    write_points3d_bin(str(sparse / "points3D.bin"), xyz, rgb, ids=np.arange(1, len(xyz) + 1),
                       errors=1.0, tracks=[((1, i),) for i in range(len(xyz))])


def _render_targets(root: Path, views, cloud, sh_degree: int, W: int, H: int, f: float,
                    shade=None) -> None:
    """Each view's render of the raw numpy ``cloud`` (the port's
    ``"torch"`` route, which matches JAX's ``"xla"`` route), times
    ``shade``, as an 8-bit PNG."""
    import torch

    from mojosplat_tpu_torch import Camera, RenderConfig, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.train import activate

    p = activate(params_from_numpy(cloud, "cpu"))
    (root / "images").mkdir(exist_ok=True)
    for name, q, t, _ in views:
        cam = Camera.create(R=qvec_to_rotmat(np.asarray(q)), T=t, H=H, W=W, fx=f, fy=f,
                            cx=W / 2, cy=H / 2, device="cpu")
        with torch.no_grad():
            img = render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                                   p["features"], cam, sh_degree=sh_degree,
                                   config=RenderConfig(raster_impl="torch")).numpy()
        save_png(img if shade is None else img * shade[..., None], str(root / "images" / name))


def jax_cloud(seed: int, n: int, sh_degree, position_scale: float, z: float) -> dict:
    """The JAX package's ``init_gaussians`` cloud, shifted to depth ``z``,
    as numpy (the reference tests' target scenes)."""
    import jax
    import jax.numpy as jnp

    from mojosplat_tpu import train as mtrain

    raw = mtrain.init_gaussians(jax.random.PRNGKey(seed), n, sh_degree=sh_degree,
                                position_scale=position_scale)
    raw["means3d"] = raw["means3d"] + jnp.array([0.0, 0.0, z])
    return {k: np.array(v) for k, v in raw.items()}


def train_capture(root: Path, cloud: dict | None = None) -> Path:
    """``tests/test_train_colmap_cli.py``'s capture: 64x48, two views, 120
    SfM points observed in both, targets rendered from ``cloud`` (by default
    its 200-gaussian JAX cloud) under a radial vignette the scene cannot
    explain."""
    W, H, f = 64, 48, 60.0
    views = [("v0.png", (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 1),
             ("v1.png", (1.0, 0.0, 0.0, 0.0), (0.1, 0.0, 0.0), 1)]
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 0.4, (120, 3)) + np.array([0.0, 0.0, 2.0])
    rgb = rng.integers(0, 256, (120, 3))
    write_sparse(root / "sparse" / "0", [(1, W, H, (f, f, W / 2, H / 2))], views, xyz, rgb,
                 observations=True)
    if cloud is None:
        cloud = jax_cloud(5, 200, 0, 0.4, 2.0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    _render_targets(root, views, cloud, 0, W, H, f,
                    shade=(1.0 - 0.35 * (xx**2 + yy**2)).astype(np.float32))
    return root


def eval_capture(root: Path) -> tuple[Path, Path]:
    """``tests/test_eval.py``'s capture: one 96x64 view of a 300-gaussian SH
    degree 1 cloud, and that cloud as ``scene.ply``."""
    W, H, f = 96, 64, 90.0
    views = [("v0.png", (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 1)]
    write_sparse(root / "sparse" / "0", [(1, W, H, (f, f, W / 2, H / 2))], views,
                 np.zeros((0, 3)), np.zeros((0, 3), np.uint8), observations=False)
    cloud = jax_cloud(5, 300, 1, 0.5, 2.5)
    _render_targets(root, views, cloud, 1, W, H, f)
    ply = root / "scene.ply"
    save_gaussian_ply(str(ply), cloud)
    return root, ply


def assert_state_equal(got, want, path="state"):
    """Two nested checkpoint states (dicts, lists, tensors, numbers) equal
    bit for bit, dtypes included."""
    import torch

    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_state_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for j, (a, b) in enumerate(zip(got, want)):
            assert_state_equal(a, b, f"{path}[{j}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), path
    else:
        assert got == want, path
