"""PyTorch port: the training CLIs on the CPU (``--device cpu --impl torch``).

``train_blender`` on tests/test_blender.py's capture (three half-red
frames at 48x48) with MCMC, as that test runs the reference CLI: ``[mcmc:``
printed and the PLY saved, plus a test split for the PSNR; ``train_demo``
(plain, ADC and MCMC) and ``train_surfel_demo`` at a tiny size, with the
loss falling and the fitted PSNR above the initial one.
"""

import os

import numpy as np
import pytest

from mojosplat_tpu_torch.examples import train_blender, train_demo, train_surfel_demo
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply
from torch_scene_tools_cases import half_red_frame, ring_poses, write_blender_split

CPU = ["--device", "cpu", "--impl", "torch"]


def test_train_blender_cli_mcmc(tmp_path, capsys):
    poses = ring_poses(3, 3.0, 0.5)
    write_blender_split(str(tmp_path), "train", poses, [half_red_frame(48, 48)] * 3, 0.9)
    write_blender_split(str(tmp_path), "test", poses[:1], [half_red_frame(48, 48)], 0.9)
    out_dir = str(tmp_path / "out")
    res = train_blender.main(["--data", str(tmp_path), "--downscale", "1", "--steps", "10",
                              "--gaussians", "256", "--sh-degree", "0", "--strategy", "mcmc",
                              "--densify-every", "5", "--eval-every", "5",
                              "--out-dir", out_dir] + CPU)
    out = capsys.readouterr().out
    assert "[mcmc:" in out and "test PSNR" in out
    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
    assert res["events"] and res["events"][0]["step"] == 5
    assert np.all(np.isfinite(res["losses"])) and np.isfinite(res["test_psnr"])
    params = load_gaussian_ply(os.path.join(out_dir, "scene_final.ply"))
    assert params["means3d"].shape == (256, 3)


@pytest.mark.parametrize("strategy", ["none", "adc", "mcmc"])
def test_train_demo_fits(tmp_path, capsys, strategy):
    dens = [] if strategy == "none" else ["--densify-every", "10", "--strategy", strategy,
                                          "--densify-grad-threshold", "1e-9"]
    res = train_demo.main(["--gt-gaussians", "300", "--fit-gaussians", "300", "--views", "2",
                           "--height", "32", "--width", "32", "--steps", "20",
                           "--steps-per-call", "10", "--out-dir", str(tmp_path)] + dens + CPU)
    out = capsys.readouterr().out
    assert res["final_psnr"] > res["initial_psnr"]
    assert np.mean(res["losses"][-3:]) < np.mean(res["losses"][:3])
    for name in ("before.png", "after.png", "target.png", "fitted.ply"):
        assert os.path.exists(tmp_path / name)
    if strategy != "none":
        tag = "[densify:" if strategy == "adc" else "[mcmc:"
        assert tag in out and [e["step"] for e in res["events"]] == [10]


def test_train_surfel_demo_fits(tmp_path):
    res = train_surfel_demo.main(["--gt-surfels", "200", "--fit-surfels", "200", "--views", "2",
                                  "--height", "32", "--width", "32", "--steps", "12",
                                  "--steps-per-call", "6", "--out-dir", str(tmp_path)] + CPU)
    assert res["final_psnr"] > res["initial_psnr"]
    assert np.mean(res["losses"][-3:]) < np.mean(res["losses"][:3])
    assert load_gaussian_ply(str(tmp_path / "fitted_surfels.ply"))["scales"].shape == (200, 2)
