"""PyTorch port: runs of the ``train_colmap`` CLI on the CPU.

The port's counterparts of tests/test_train_colmap_cli.py's three runs on
its capture (``torch_colmap_cases.train_capture``), through
``mojosplat_tpu_torch.examples.train_colmap.main`` with ``--device cpu
--impl torch`` and the same flags and asserts: ``--bilagrid`` (the grids
move off identity), ADC with the opacity reset and the depth loss, 2DGS
with MCMC (the (N, 2) surfel PLY). Also the CLI's refusals (``--multihost``,
no card, the kernels off the card, ADC with surfels) and ``--resume``.
"""

import os

import numpy as np
import pytest
import torch

from mojosplat_tpu_torch.examples import train_colmap
from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils.checkpoint import restore_checkpoint
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply
from torch_colmap_cases import assert_state_equal, train_capture

CPU = ["--device", "cpu", "--impl", "torch", "--downscale", "1", "--max-gaussians", "256",
       "--sh-degree", "0", "--save-every", "0"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return train_capture(tmp_path_factory.mktemp("capture"))


def test_train_cli_with_bilagrid(capture, tmp_path, capsys):
    out_dir = str(tmp_path / "out")
    result = train_colmap.main(["--data", str(capture), "--steps", "25", "--bilagrid",
                                "--bilagrid-lr", "5e-3", "--out-dir", out_dir] + CPU)
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
    grids = np.load(os.path.join(out_dir, "bilateral_grids.npy"))
    assert grids.shape[0] == 2 and grids.shape[-1] == 12
    # The vignette is unexplainable by the scene: the grids must have moved
    # off identity, and training must report finite losses.
    ident = np.concatenate([np.eye(3).reshape(9), np.zeros(3)])
    dev = np.abs(grids - ident).mean()
    assert dev > 1e-4, f"grids stayed at identity (mean dev {dev})"
    assert "bilateral grids" in out and np.all(np.isfinite(result["losses"]))
    # The disabled groups got no step: exactly at identity.
    vp = result["state"]["view_params"]
    assert not vp["pose"].any() and not vp["intr"].any()
    assert torch.equal(vp["expo"], torch.eye(3, 4).expand(2, 3, 4))


def test_train_cli_with_adc(capture, tmp_path, capsys):
    """--strategy adc: clone/split/prune from the accumulated view-space
    gradient statistic, with the periodic opacity reset and the depth loss."""
    out_dir = str(tmp_path / "out_adc")
    train_colmap.main(["--data", str(capture), "--steps", "12", "--strategy", "adc",
                       "--densify-every", "5", "--densify-grad-threshold", "1e-7",
                       "--opacity-reset-every", "10", "--depth-loss", "0.05",
                       "--out-dir", out_dir] + CPU)
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
    assert "[densify:" in out and "[opacity reset]" in out
    assert "ADC scene extent" in out
    assert "depth supervision:" in out


def test_train_cli_2dgs(capture, tmp_path, capsys):
    """--primitive 2dgs with MCMC and the depth loss: the saved PLY carries
    the (N, 2) surfel-scale layout."""
    out_dir = str(tmp_path / "out_2dgs")
    train_colmap.main(["--data", str(capture), "--steps", "12", "--primitive", "2dgs",
                       "--strategy", "mcmc", "--densify-every", "6", "--depth-loss", "0.05",
                       "--out-dir", out_dir] + CPU)
    out = capsys.readouterr().out
    params = load_gaussian_ply(os.path.join(out_dir, "scene_final.ply"))
    assert params["scales"].shape[-1] == 2
    assert np.all(np.isfinite(params["means3d"]))
    assert "[mcmc:" in out


def test_cli_refuses(capture, tmp_path, monkeypatch):
    base = ["--data", str(capture), "--out-dir", str(tmp_path), "--steps", "1"]
    # --multihost with no rendezvous configured (neither the MOJOSPLAT_*
    # variables nor torchrun's): init_multihost raises.
    for k in ("MOJOSPLAT_COORDINATOR", "MOJOSPLAT_NUM_PROCESSES", "MOJOSPLAT_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs a rendezvous"):
        train_colmap.main(base + ["--device", "cpu", "--impl", "torch", "--multihost"])
    # The card by default: there is none here, so the defaults raise.
    with pytest.raises(SystemExit, match="is_available"):
        train_colmap.main(base)
    with pytest.raises(SystemExit, match="--impl cuda"):
        train_colmap.main(base + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="adc"):
        train_colmap.main(base + CPU + ["--primitive", "2dgs", "--strategy", "adc"])


def test_resume_continues_the_run(capture, tmp_path):
    """ADC with the view groups on: 4 steps checkpointed at step 4, then
    --resume to step 6. The checkpoint restores bit-equal (every tensor,
    both optimizers' states, the DensifyState, the generator); the resumed
    run's first step is the step loss of the checkpointed state at the view
    sequence's first draw (it restarts there, as the reference's does)."""
    flags = ["--data", str(capture), "--strategy", "adc", "--densify-every", "3",
             "--densify-grad-threshold", "1e-7", "--depth-loss", "0.05", "--pose-opt",
             "--exposure-opt", "--bilagrid", "--out-dir", str(tmp_path)] + CPU
    first = train_colmap.main(flags + ["--steps", "4", "--ckpt-every", "4"])
    saved = restore_checkpoint(str(tmp_path / "ckpt"))
    assert_state_equal(saved, first["state"])
    assert saved["step"] == 4 and "dstate" in saved and saved["view_adam"]["state"]
    assert first["events"] and first["events"][0]["kind"] == "densify"
    resumed = train_colmap.main(flags + ["--steps", "6", "--resume"])
    assert len(resumed["losses"]) == 2 and resumed["state"]["step"] == 6

    args = train_colmap.build_parser().parse_args(flags + ["--steps", "6"])
    scene = cm.load_scene(str(capture / "sparse" / "0"), with_points2d=True)
    views, images = train_colmap.load_view_images(str(capture), scene, 1)
    depth = cm.sparse_depth_targets(scene, views, 1)
    i = int(np.random.default_rng(0).integers(len(views)))
    loss, _ = train_colmap.step_loss(
        saved["params"], saved["view_params"], i, scene.camera_for(views[i], 1, device="cpu"),
        torch.from_numpy(images[i]), [torch.from_numpy(a[i]) for a in depth], args,
        train_colmap.render_config(args, surfels=False), 0, torch.zeros((256, 2)))
    assert float(loss) == resumed["losses"][0]
