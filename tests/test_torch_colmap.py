"""PyTorch port: the COLMAP and Blender loaders against the JAX package's.

``utils.colmap``: ``load_scene`` with and without the 2D observations,
every camera model the loaders map (the seven with a lens: SIMPLE_RADIAL,
RADIAL, OPENCV, FULL_OPENCV, OPENCV_FISHEYE, SIMPLE_RADIAL_FISHEYE,
RADIAL_FISHEYE; and the two pinholes) through ``camera_for`` at two
downscales against the JAX ``Camera``'s fields, ``sparse_depth_targets``,
and ``init_gaussians_from_points`` with its KNN on the exact blocked path
and on the Morton-window path (a small ``max_exact``): all bit-equal.
``utils.blender.load_blender_scene`` and its cameras, bit-equal.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from mojosplat_tpu.utils import blender as jblender
from mojosplat_tpu.utils import colmap as jcm
from mojosplat_tpu_torch.utils import blender, colmap as cm
from torch_colmap_cases import CAMERA_MODELS, write_sparse

CAMERA_FIELDS = ("R", "T", "fx", "fy", "cx", "cy", "near", "far", "dist", "rs_vel")


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    """Every camera model (view i uses camera 1 + i), nine views (view 2
    behind its points, some rotated), 200 points observed in every view, a
    few of them out of frame."""
    d = tmp_path_factory.mktemp("sparse")
    rng = np.random.default_rng(1)
    cams = [(model, 64, 48, params) for model, params in CAMERA_MODELS.values()]
    views = [(f"v{i}.png", tuple(q), tuple(t), 1 + i % len(cams)) for i, (q, t) in enumerate([
        ((1, 0, 0, 0), (0, 0, 0)), ((0.99, 0.1, 0.0, 0.05), (0.2, -0.1, 0.3)),
        ((1, 0, 0, 0), (0, 0, -9.0)), ((0.9, 0.0, 0.3, 0.1), (0.1, 0.2, 0.0)),
        ((1, 0, 0, 0), (1.5, 0, 0)), ((0.7, 0.1, 0.1, 0.7), (0, 0.4, 0.5)),
        ((1, 0, 0, 0), (0.1, 0.1, 0.2)), ((0.98, -0.1, 0.1, 0.0), (0, 0, 0.5)),
        ((1, 0.05, 0, 0), (-0.2, 0, 0))])]
    xyz = rng.normal(0, 0.6, (200, 3)) + [0, 0, 3.0]
    write_sparse(d, cams, views, xyz, rng.integers(0, 256, (200, 3)), observations=True)
    return d


def assert_scene_equal(got, want):
    assert got.cameras.keys() == want.cameras.keys()
    for cid, c in want.cameras.items():
        g = got.cameras[cid]
        assert (g.model_id, g.width, g.height) == (c.model_id, c.width, c.height)
        np.testing.assert_array_equal(g.params, c.params)
    assert [im.name for im in got.images] == [im.name for im in want.images]
    for g, w in zip(got.images, want.images):
        assert (g.image_id, g.camera_id) == (w.image_id, w.camera_id)
        for k in ("qvec", "tvec", "xys", "point3d_ids"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), k
            if b is not None:
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("points_xyz", "points_rgb", "points_id"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if b is not None:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("with_points2d", [False, True])
def test_load_scene_matches_jax(sparse, with_points2d):
    got = cm.load_scene(str(sparse), with_points2d=with_points2d)
    want = jcm.load_scene(str(sparse), with_points2d=with_points2d)
    assert_scene_equal(got, want)
    assert len(got.images) == 9 and len(got.points_xyz) == 200


@pytest.mark.parametrize("downscale", [1, 2])
def test_camera_for_every_model_matches_jax(sparse, downscale):
    scene, jscene = cm.load_scene(str(sparse)), jcm.load_scene(str(sparse))
    models = set()
    for im, jim in zip(scene.images, jscene.images):
        cam = scene.camera_for(im, downscale, device="cpu")
        jcam = jscene.camera_for(jim, downscale)
        assert (cam.H, cam.W, cam.camera_model, cam.shutter) == (
            jcam.H, jcam.W, jcam.camera_model, jcam.shutter)
        for k in CAMERA_FIELDS:
            got, want = getattr(cam, k), np.asarray(getattr(jcam, k))
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        models.add(scene.cameras[im.camera_id].model_id)
    for cam in scene.cameras.values():
        got = cm.camera_intrinsics(cam, downscale)
        assert got[4:6] == jcm.camera_intrinsics(cam, downscale)[4:6]
    assert cm.camera_intrinsics(scene.cameras[6], 1)[7] == "fisheye"  # OPENCV_FISHEYE
    assert len(models) == len(CAMERA_MODELS)


def test_sparse_depth_targets_match_jax(sparse):
    scene = cm.load_scene(str(sparse), with_points2d=True)
    jscene = jcm.load_scene(str(sparse), with_points2d=True)
    for downscale, capacity in ((1, None), (2, 64)):
        got = cm.sparse_depth_targets(scene, scene.images, downscale, capacity)
        want = jcm.sparse_depth_targets(jscene, jscene.images, downscale, capacity)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        mask = got[2]
        assert 0 < mask.sum() < mask.size and not mask[2].any()  # view 2 sees nothing
    with pytest.raises(ValueError):
        cm.sparse_depth_targets(cm.load_scene(str(sparse)), scene.images)


@pytest.mark.parametrize("sh_degree", [3, None])
def test_init_gaussians_from_points_matches_jax(sparse, sh_degree):
    scene = cm.load_scene(str(sparse))
    got = cm.init_gaussians_from_points(scene.points_xyz, scene.points_rgb, sh_degree)
    want = jcm.init_gaussians_from_points(scene.points_xyz, scene.points_rgb, sh_degree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n,max_exact,block", [(700, 131072, 128), (3000, 500, 4096)])
def test_knn_exact_and_morton_paths_match_jax(n, max_exact, block):
    xyz = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    xyz[5] = xyz[6]  # a duplicate point: a zero distance
    got = cm._mean_knn_dist(xyz, k=3, block=block, max_exact=max_exact)
    want = jcm._mean_knn_dist(xyz, k=3, block=block, max_exact=max_exact)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_load_blender_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        rgba = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
        Image.fromarray(rgba).save(tmp_path / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    for downscale in (1, 2):
        got = blender.load_blender_scene(str(tmp_path), background=(0.2, 0.5, 1.0),
                                         downscale=downscale)
        want = jblender.load_blender_scene(str(tmp_path), background=(0.2, 0.5, 1.0),
                                           downscale=downscale)
        assert got.names == want.names
        assert (got.H, got.W, got.fx, got.fy) == (want.H, want.W, want.fx, want.fy)
        for k in ("R", "T", "images"):
            assert getattr(got, k).dtype == getattr(want, k).dtype, k
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        cam, jcam = got.camera_for(1, device="cpu"), want.camera_for(1)
        for k in CAMERA_FIELDS:
            np.testing.assert_array_equal(getattr(cam, k).numpy(), np.asarray(getattr(jcam, k)))
    meta_only = blender.load_blender_scene(str(tmp_path), load_images=False)
    assert meta_only.images is None and (meta_only.H, meta_only.W) == (800, 800)
