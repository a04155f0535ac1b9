"""PyTorch port: the ``eval_colmap`` CLI against the JAX package's.

On tests/test_eval.py's capture (``torch_colmap_cases.eval_capture``: one
view rendered from a known cloud, the cloud as PLY), the port's
``mojosplat_tpu_torch.examples.eval_colmap.main`` (``--device cpu --impl
torch``) against ``examples/eval_colmap.py`` (``--impl xla``): the summary
(views, mean PSNR and SSIM) within 1e-4 dB and 1e-5; PSNR at the 8-bit
ceiling as tests/test_eval.py asserts. On a tinted copy of the capture, the
test-time ``--appearance-opt`` rows (affine and bilateral grid, a few Adam
steps each, where the two optimizers take the same steps to f32 rounding)
against JAX's within 1e-3 dB; and, as tests/test_eval.py asserts, 150
affine steps lift the right half's PSNR 3 dB above the raw render's.
"""

import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from mojosplat_tpu_torch.examples import eval_colmap
from torch_colmap_cases import eval_capture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root, ply = eval_capture(tmp_path_factory.mktemp("capture"))
    tinted = root.parent / "tinted"
    shutil.copytree(root, tinted)
    for f in (tinted / "images").iterdir():
        img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        img = np.clip(img * np.array([1.2, 0.8, 1.0]) + 0.03, 0, 1)
        Image.fromarray((img * 255).round().astype(np.uint8)).save(f)
    return root, tinted, ply


def jax_eval(argv, capsys):
    """examples/eval_colmap.py on ``argv`` (its ``--impl xla`` route): the
    summary it prints last."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    old = sys.argv
    sys.argv = ["eval_colmap.py"] + argv + ["--impl", "xla"]
    try:
        runpy.run_path(os.path.join(ROOT, "examples", "eval_colmap.py"), run_name="__main__")
    finally:
        sys.argv = old
        sys.path.remove(os.path.join(ROOT, "examples"))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def port_eval(argv, capsys):
    summary = eval_colmap.main(argv + ["--device", "cpu", "--impl", "torch"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: v for k, v in summary.items() if k != "rows"}
    return printed


def test_eval_summary_matches_jax(capture, capsys):
    root, _, ply = capture
    argv = ["--data", str(root), "--ply", str(ply), "--downscale", "1", "--every", "1"]
    got, want = port_eval(argv, capsys), jax_eval(argv, capsys)
    assert got["views"] == want["views"] == 1
    assert abs(got["mean_psnr"] - want["mean_psnr"]) <= 1e-4, (got, want)
    assert abs(got["mean_ssim"] - want["mean_ssim"]) <= 1e-5, (got, want)
    assert got["mean_psnr"] > 45.0 and got["mean_ssim"] > 0.99  # the 8-bit ceiling


@pytest.mark.parametrize("app", ["affine", "bilagrid"])
def test_appearance_rows_match_jax(capture, capsys, app):
    _, tinted, ply = capture
    argv = ["--data", str(tinted), "--ply", str(ply), "--downscale", "1", "--every", "1",
            "--appearance-opt", app, "--appearance-steps", "5", "--appearance-lr", "1e-2"]
    got, want = port_eval(argv, capsys), jax_eval(argv, capsys)
    for k in ("mean_psnr", "mean_psnr_right_raw", "mean_psnr_right_corrected"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got, want)
    assert got["mean_psnr_right_corrected"] != got["mean_psnr_right_raw"]


def test_appearance_opt_lifts_the_right_half(capture, capsys):
    _, tinted, ply = capture
    got = port_eval(["--data", str(tinted), "--ply", str(ply), "--downscale", "1", "--every",
                     "1", "--appearance-opt", "affine", "--appearance-steps", "150",
                     "--appearance-lr", "1e-2"], capsys)
    assert got["mean_psnr_right_corrected"] > got["mean_psnr_right_raw"] + 3.0, got
