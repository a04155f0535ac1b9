"""PyTorch port: the synthetic COLMAP capture maker and its SfM resampler
against ``scripts/make_synth_colmap.py`` and ``scripts/resample_sfm.py``.

The reference scripts read MS_* variables when they are imported, so each
is loaded by path after ``setenv``. ``build_scene``, ``ring_cameras`` and
``rotmat_to_qvec`` are bit-equal, and the scene leaves the generator where
the reference's leaves it. A tiny capture (32x32, 2 views, 300 SfM points,
50 observations a view, detail 0.02) is made by the port's ``main`` on the
CPU and by the reference script's own ``main`` with its config's route
switched to ``"xla"`` (its ``"pallas"`` route needs the TPU or interpret
mode): the sparse model and ``gt.ply`` are byte-equal and the PNGs within
one level (the two routes' f32 alphas flip a threshold on a few values).
The resampler run by both packages on copies of the capture writes
byte-equal files, with and without replacement.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu_torch.examples import make_synth_colmap, resample_sfm
from mojosplat_tpu_torch.utils.colmap import qvec_to_rotmat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(MS_H="32", MS_W="32", MS_NVIEWS="2", MS_NSFM="300", MS_NOBS="50",
            MS_DETAIL="0.02")
SPARSE_FILES = ("cameras.bin", "images.bin", "points3D.bin")


def load_script(name: str, env: dict):
    """scripts/<name>.py of the reference, imported with ``env`` set."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The tiny capture made by both packages: (port dir, reference dir)."""
    root = tmp_path_factory.mktemp("capture")
    port, ref = root / "port", root / "reference"
    make_synth_colmap.main([
        "--out", str(port), "--height", TINY["MS_H"], "--width", TINY["MS_W"],
        "--views", TINY["MS_NVIEWS"], "--sfm-points", TINY["MS_NSFM"],
        "--obs-per-view", TINY["MS_NOBS"], "--detail", TINY["MS_DETAIL"],
        "--device", "cpu", "--impl", "torch"])
    mod = load_script("make_synth_colmap", dict(TINY, MS_OUT=str(ref)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "RenderConfig", lambda **kw: JConfig(**dict(kw, raster_impl="xla")))
        mod.main()
    return port, ref


@pytest.mark.parametrize("detail", [0.02, 0.05])
def test_build_scene_bit_equal(detail):
    mod = load_script("make_synth_colmap", dict(MS_DETAIL=str(detail)))
    rng_ref, rng = np.random.default_rng(7), np.random.default_rng(7)
    want = mod.build_scene(rng_ref)
    got = make_synth_colmap.build_scene(rng, detail)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(v)), k
    assert rng.bit_generator.state == rng_ref.bit_generator.state


@pytest.mark.parametrize("n_views", [2, 28])
def test_ring_cameras_and_qvec_bit_equal(n_views):
    mod = load_script("make_synth_colmap", dict(MS_NVIEWS=str(n_views)))
    want = mod.ring_cameras()
    got = make_synth_colmap.ring_cameras(n_views)
    assert len(got) == len(want) == n_views
    for (R, T), (jR, jT) in zip(got, want):
        assert R.dtype == T.dtype == np.float32
        assert np.array_equal(R, jR) and np.array_equal(T, jT)
    # Every branch of the conversion: the ring's poses, random rotations and
    # half turns about each axis (trace -1, one diagonal term largest).
    rots = [R for R, _ in want]
    rots += [qvec_to_rotmat(q) for q in np.random.default_rng(0).normal(size=(64, 4))]
    rots += [np.diag(d).astype(np.float64) for d in ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    for R in rots:
        q = make_synth_colmap.rotmat_to_qvec(R)
        assert np.array_equal(q, mod.rotmat_to_qvec(R))
    assert {np.argmax(np.abs(make_synth_colmap.rotmat_to_qvec(R))) for R in rots} == {0, 1, 2, 3}


def test_capture_matches_reference(captures):
    port, ref = captures
    for name in SPARSE_FILES:
        assert (port / "sparse" / "0" / name).read_bytes() == \
            (ref / "sparse" / "0" / name).read_bytes(), name
    assert (port / "gt.ply").read_bytes() == (ref / "gt.ply").read_bytes()
    views = sorted(p.name for p in (ref / "images").iterdir())
    assert views == sorted(p.name for p in (port / "images").iterdir()) == [
        "view_000.png", "view_001.png"]
    off = 0
    for v in views:
        a = np.asarray(Image.open(port / "images" / v), np.int16)
        b = np.asarray(Image.open(ref / "images" / v), np.int16)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, v
        off += int((a != b).sum())
    # Threshold flips: on this capture none of the 6144 values differs.
    assert off <= 16, off


@pytest.mark.parametrize("n_sfm", [500, 5000])  # the scene holds 2,876: then with replacement
def test_resample_matches_reference(captures, tmp_path, n_sfm):
    port, _ = captures
    roots = []
    for side in ("port", "reference"):
        root = tmp_path / side
        shutil.copytree(port / "sparse", root / "sparse")
        shutil.copyfile(port / "gt.ply", root / "gt.ply")
        roots.append(root)
    out = resample_sfm.main(["--root", str(roots[0]), "--sfm-points", str(n_sfm),
                             "--obs-per-view", "40"])
    assert out["points"] == n_sfm and out["replace"] == (n_sfm > 2876)
    load_script("resample_sfm", dict(MS_ROOT=str(roots[1]), MS_NSFM=str(n_sfm),
                                     MS_NOBS="40")).main()
    for name in SPARSE_FILES:
        got = (roots[0] / "sparse" / "0" / name).read_bytes()
        assert got == (roots[1] / "sparse" / "0" / name).read_bytes(), name
    assert sorted(os.listdir(roots[0] / "sparse")) == ["0"]


def test_defaults_read_the_reference_variables(monkeypatch):
    monkeypatch.setenv("MS_OUT", "/x/hd")
    monkeypatch.setenv("MS_H", "540")
    monkeypatch.setenv("MS_W", "960")
    monkeypatch.setenv("MS_NVIEWS", "48")
    monkeypatch.setenv("MS_NSFM", "60000")
    monkeypatch.setenv("MS_NOBS", "3000")
    monkeypatch.setenv("MS_DETAIL", "2.5")
    a = make_synth_colmap.build_parser().parse_args([])
    assert (a.out, a.height, a.width, a.views, a.sfm_points, a.obs_per_view, a.detail) == (
        "/x/hd", 540, 960, 48, 60000, 3000, 2.5)
    monkeypatch.setenv("MS_ROOT", "/x/hd")
    r = resample_sfm.build_parser().parse_args([])
    assert (r.root, r.sfm_points, r.obs_per_view) == ("/x/hd", 60000, 3000)
    monkeypatch.delenv("MS_NSFM")
    monkeypatch.delenv("MS_NOBS")
    assert make_synth_colmap.build_parser().parse_args([]).sfm_points == 30_000
    assert resample_sfm.build_parser().parse_args([]).sfm_points == 110_000


def test_maker_refuses_cuda_off_the_card(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        make_synth_colmap.main(["--out", str(tmp_path), "--device", "cpu", "--impl", "cuda"])
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        make_synth_colmap.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("module", ["make_synth_colmap", "resample_sfm"])
def test_module_imports_no_jax(module):
    code = (
        "import sys\n"
        f"import mojosplat_tpu_torch.examples.{module}\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'mojosplat_tpu' or m.startswith('mojosplat_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
