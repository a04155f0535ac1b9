"""PyTorch port: the ``compress_scene`` and ``extract_mesh`` CLIs against
the reference's (run with ``runpy``), and every new CLI's refusals.

``compress_scene``: the same PLY compressed by both CLIs gives the same
``.npz`` member for member, byte for byte (the zip's timestamps differ),
and expanding it gives byte-equal PLYs. ``extract_mesh`` on a small surfel
PLY (tests/test_mesh.py's sphere) against the reference CLI at ``--impl
xla``: vertex counts within 2%, symmetric Chamfer distance under half a
voxel. The CLIs' draws differ from the reference's, so the meshes are held
by what they must achieve, not bit for bit.
"""

import os
import runpy
import sys
import zipfile

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from mojosplat_tpu_torch.examples import (
    compress_scene,
    extract_mesh,
    orbit_demo,
    render_sample,
    train_blender,
    train_demo,
    train_surfel_demo,
    viewer,
)
from mojosplat_tpu_torch.utils.ply import save_gaussian_ply
from torch_scene_tools_cases import surfel_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--impl", "torch"]


def run_reference(script: str, argv: list) -> None:
    """Run examples/<script> of the reference package as ``__main__``."""
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(REPO, "examples", script), run_name="__main__")
    finally:
        sys.argv = saved


def scene_ply(path, n=400, sh_degree=2, seed=3):
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    save_gaussian_ply(str(path), dict(
        means3d=rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        scales=rng.normal(-3.0, 0.4, (n, 3)).astype(np.float32),
        quats=quats / np.linalg.norm(quats, axis=1, keepdims=True),
        opacities_raw=rng.normal(0.5, 1.0, n).astype(np.float32),
        features=rng.normal(0, 0.3, (n, K, 3)).astype(np.float32)))
    return str(path)


def zip_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


@pytest.mark.parametrize("codebook", ["16", "0"])
def test_compress_scene_cli_matches_reference(tmp_path, codebook):
    src = scene_ply(tmp_path / "scene.ply")
    want, got = tmp_path / "want.npz", tmp_path / "got.npz"
    run_reference("compress_scene.py", [src, str(want), "--codebook", codebook])
    stats = compress_scene.main([src, str(got), "--codebook", codebook] + CPU)
    assert stats["n"] == 400 and stats["ratio"] > 1.0
    assert zip_members(got) == zip_members(want)
    # And back: the expanded PLYs, byte for byte.
    run_reference("compress_scene.py", [str(want), str(tmp_path / "want.ply")])
    compress_scene.main([str(got), str(tmp_path / "got.ply")] + CPU)
    assert (tmp_path / "got.ply").read_bytes() == (tmp_path / "want.ply").read_bytes()


def sphere_ply(path):
    p = surfel_sphere()
    p["opacities_raw"] = np.log(p["opacities"] / (1.0 - p["opacities"]))
    del p["opacities"]
    save_gaussian_ply(str(path), p)
    return str(path)


def read_mesh_ply(path):
    """Vertices of a binary mesh PLY from ``save_mesh_ply``."""
    blob = open(path, "rb").read()
    head, body = blob.split(b"end_header\n", 1)
    nv = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    return np.frombuffer(body[: 12 * nv], "<f4").reshape(nv, 3)


def test_extract_mesh_cli_matches_reference(tmp_path):
    src = sphere_ply(tmp_path / "sphere.ply")
    flags = ["--views", "6", "--height", "64", "--width", "64", "--res", "40"]
    run_reference("extract_mesh.py", [src, str(tmp_path / "want.ply"), "--impl", "xla"] + flags)
    out = extract_mesh.main([src, str(tmp_path / "got.ply")] + flags + CPU)
    want = read_mesh_ply(tmp_path / "want.ply")
    got = read_mesh_ply(tmp_path / "got.ply")
    np.testing.assert_array_equal(got, out["verts"])
    assert len(want) > 500
    assert abs(len(got) - len(want)) <= 0.02 * len(want)
    chamfer = 0.5 * (cKDTree(want).query(got)[0].mean() + cKDTree(got).query(want)[0].mean())
    assert chamfer < 0.5 * float(out["spacing"][0]), chamfer
    assert set(out["times"]) == {"render", "fuse", "extract"}
    assert (out["faces"] >= 0).all() and (out["faces"] < len(got)).all()


REFUSALS = [
    (render_sample.main, []),
    (orbit_demo.main, []),
    (viewer.build_viewer, []),
    (compress_scene.main, ["a.ply", "b.npz"]),
    (extract_mesh.main, ["a.ply", "b.ply"]),
    (train_demo.main, []),
    (train_surfel_demo.main, []),
    (train_blender.main, ["--data", "nowhere"]),
]


@pytest.mark.parametrize("entry", range(len(REFUSALS)))
@pytest.mark.parametrize("flags", [[], ["--device", "cpu"]], ids=["card", "kernels_on_cpu"])
def test_cli_refuses_without_card(entry, flags, monkeypatch):
    """The defaults (the card and the kernels) raise without a card, and
    ``--impl cuda`` raises on the CPU: no CLI falls back by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, argv = REFUSALS[entry]
    with pytest.raises(SystemExit, match="cuda"):
        fn(argv + flags)
