"""PyTorch port: the IO modules against the JAX package's.

PLY (3DGS and the (N, 2) surfel layout), splat and the compressed format
written by each package and read by the other, bit-equal both ways (the
PLY and splat files byte-equal); the port's PNG bytes equal to JAX's
``encode_png`` and its native ``write_png``; the native C readers equal to
the pure-Python ones (PLY, and the COLMAP cameras, images and points); the
native library built from the port's own source into ``build/``.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from mojosplat_tpu import train as jtrain
from mojosplat_tpu.utils import compress as jcompress
from mojosplat_tpu.utils import image as jimage
from mojosplat_tpu.utils import ply as jply
from mojosplat_tpu.utils import splat as jsplat
from mojosplat_tpu_torch import native
from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils import compress, image, ply, splat
from torch_colmap_cases import CAMERA_MODELS, write_sparse

ROOT = Path(__file__).resolve().parent.parent


def scene(n=60, sh_degree=2, surfel=False, seed=7):
    raw = jtrain.init_gaussians(jax.random.PRNGKey(seed), n, sh_degree=sh_degree)
    raw = {k: np.asarray(v) for k, v in raw.items()}
    if surfel:
        raw["scales"] = np.ascontiguousarray(raw["scales"][:, :2])
    return raw


def assert_params_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_builds_from_the_ports_source():
    mod = native.get_native()
    assert mod is not None, "the native IO did not build (see the warning logged)"
    path = Path(mod.__file__)
    assert path.is_relative_to(ROOT / "build" / "native")
    assert native.SOURCE == ROOT / "mojosplat_tpu_torch" / "native" / "io_native.c"


@pytest.mark.parametrize("kind", ["3dgs", "surfel", "rgb"])
def test_ply_across_packages(kind, tmp_path):
    raw = scene(sh_degree=None if kind == "rgb" else 2, surfel=kind == "surfel")
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_gaussian_ply(ours, raw)
    jply.save_gaussian_ply(theirs, raw)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    want = jply.load_gaussian_ply(theirs)
    assert_params_equal(ply.load_gaussian_ply(theirs), want)
    assert_params_equal(jply.load_gaussian_ply(ours), ply.load_gaussian_ply(ours))
    if kind == "surfel":
        assert want["scales"].shape[-1] == 2
    # Native against pure Python, reading and writing.
    assert ply._read_ply_python(ours) == tuple(native.get_native().load_ply(ours))
    names, n, blob = ply._read_ply_python(ours)
    ply._write_ply_python(str(tmp_path / "py.ply"), names, n, blob)
    assert (tmp_path / "py.ply").read_bytes() == Path(ours).read_bytes()


def test_ply_rejects_garbage(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        ply._read_ply_python(str(path))
    with pytest.raises(ValueError):
        ply.load_gaussian_ply(str(path))


def test_splat_across_packages(tmp_path):
    raw = scene(n=80)
    ours, theirs = str(tmp_path / "port.splat"), str(tmp_path / "jax.splat")
    splat.save_gaussian_splat(ours, raw)
    jsplat.save_gaussian_splat(theirs, raw)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    assert_params_equal(splat.load_gaussian_splat(theirs), jsplat.load_gaussian_splat(theirs))


@pytest.mark.parametrize("codebook", [64, None])
def test_compress_writer_across_packages(codebook, tmp_path):
    raw = scene(n=300, sh_degree=2)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    stats = compress.compress_scene(ours, raw, sh_codebook_size=codebook, kmeans_sample=200)
    jstats = jcompress.compress_scene(theirs, raw, sh_codebook_size=codebook,
                                      kmeans_sample=200)
    assert {k: v for k, v in stats.items() if k not in ("bytes", "ratio")} == {
        k: v for k, v in jstats.items() if k not in ("bytes", "ratio")}
    with np.load(ours) as a, np.load(theirs) as b:  # the zip's timestamps differ
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    assert_params_equal(compress.load_compressed_scene(theirs),
                        jcompress.load_compressed_scene(theirs))
    assert_params_equal(jcompress.load_compressed_scene(ours),
                        compress.load_compressed_scene(ours))
    np.testing.assert_array_equal(compress.morton_order(raw["means3d"]),
                                  jcompress.morton_order(raw["means3d"]))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_bytes_match_jax(channels, tmp_path):
    img = np.random.default_rng(channels).uniform(-0.1, 1.1, (19, 23, channels)).astype(
        np.float32)
    np.testing.assert_array_equal(image.to_uint8(img), jimage.to_uint8(img))
    arr = image.to_uint8(img)
    assert image.encode_png(arr) == jimage.encode_png(arr)
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    image.save_png(img, str(ours))
    jimage.save_png(img, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours,):
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back.reshape(arr.shape), arr)


def test_png_without_native_is_encode_png(tmp_path, monkeypatch):
    img = np.random.default_rng(0).uniform(0, 1, (9, 7, 3)).astype(np.float32)
    monkeypatch.setattr(native, "get_native", lambda: None)
    path = tmp_path / "py.png"
    image.save_png(img, str(path))
    assert path.read_bytes() == jimage.encode_png(jimage.to_uint8(img))


def test_colmap_native_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    cams = [(model, 64, 48, params) for model, params in CAMERA_MODELS.values()]
    views = [(f"img_{i:02d}.png", tuple(rng.normal(size=4)), tuple(rng.normal(size=3)),
              1 + i % len(cams)) for i in range(5)]
    xyz = rng.normal(0, 1, (40, 3)) + [0, 0, 4]
    write_sparse(tmp_path, cams, views, xyz, rng.integers(0, 256, (40, 3)), observations=True)
    nat = native.get_native()
    assert nat is not None
    py_cams = cm._read_cameras_python(str(tmp_path / "cameras.bin"))
    nat_cams = cm.read_cameras_bin(str(tmp_path / "cameras.bin"))
    assert len(py_cams) == len(nat_cams) == len(cams)
    for a, b in zip(py_cams, nat_cams):
        assert (a.camera_id, a.model_id, a.width, a.height) == (
            b.camera_id, b.model_id, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    py_ims = cm._read_images_python(str(tmp_path / "images.bin"))
    nat_ims = cm.read_images_bin(str(tmp_path / "images.bin"))
    for a, b in zip(py_ims, nat_ims):
        assert (a.image_id, a.camera_id, a.name) == (b.image_id, b.camera_id, b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    for a, b in zip(cm._read_points_python(str(tmp_path / "points3D.bin")),
                    cm.read_points3d_bin(str(tmp_path / "points3D.bin"))):
        np.testing.assert_array_equal(a, b)
    assert os.path.getsize(tmp_path / "points3D.bin") > 0
