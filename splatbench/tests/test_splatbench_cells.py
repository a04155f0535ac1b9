"""Runs of the toy cells on the CPU through everything but the look for a
card: each is correct as the port stands, and each fault planted in the
timed path turns ``correct`` false."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from splatbench import run
from splatbench.harness import program
from splatbench.tests import toy

SEED = 2**31 + 4242
CELLS = ["toy-3dgs-train", "toy-2dgs-train", "toy-3dgs-orbit", "toy-2dgs-orbit"]


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return toy.write_root(tmp_path_factory.mktemp("toy"))


def go(root, cell, trace=False, plant=None):
    return run.run_cell(cell, SEED, 0.3, trace, torch.device("cpu"), root=root, plant=plant)


@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_is_correct(root, cell):
    res = go(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    kind = cell.rsplit("-", 1)[1]
    want = {"setup_s"} | ({"train_steps_per_s"} if kind == "train" else
                          {"render_fps", "render_p95_ms"})
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks" and res["checks"]["dropped"]["value"] == 0


@pytest.mark.parametrize("cell", ["toy-3dgs-train", "toy-2dgs-orbit"])
def test_toy_cell_traced(root, cell):
    res = go(root, cell, trace=True)
    assert res["correct"]
    assert res["metrics"]["toy_units"]["value"] == res["attempted"]
    kind = "train" if "train" in cell else "render"
    assert f"mfu.{kind}" in res["metrics"] and f"device_idle.{kind}" in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def unchanged_state(cell):
    """The optimizer's step leaves the parameters and its state as they were."""
    cell.opt.step = lambda *a, **k: None


def half_rows_train(cell):
    """Each step's loss over the top half of the view's rows, the mean over
    those alone: half the batch's pixels left out."""
    h = cell.mix["height"] // 2
    cams = [program.camera(dict(p, H=h), cell.dev) for p in cell.poses]
    real = type(cell).step

    def step(v):
        keep = cell.cams, cell.targets
        cell.cams, cell.targets = cams, cell.targets[:, :h]
        try:
            return real(cell, v)
        finally:
            cell.cams, cell.targets = keep
    cell.step = step


def answer_altered(cell):
    """One pixel block of every frame brightened where the frame is made."""
    real = cell.frame

    def frame(k):
        img, aux = real(k)
        img = img.clone()
        img[:4, :4] += 0.25
        return img, aux
    cell.frame = frame


def half_frame(cell):
    """The bottom half of each frame left out (left black)."""
    real = cell.frame

    def frame(k):
        img, aux = real(k)
        img = img.clone()
        img[img.shape[0] // 2:] = 0.0
        return img, aux
    cell.frame = frame


def drops(cell):
    """A tile budget of 32 slots, under the toy views' largest tiles (62-67):
    the blend drops slots."""
    cell.cfg = type(cell.cfg)(**dict(cell.cfg.__dict__, tile_capacity=32, chunk_size=32))


@pytest.mark.parametrize("cell, fault", [
    ("toy-3dgs-train", unchanged_state), ("toy-2dgs-train", unchanged_state),
    ("toy-3dgs-train", half_rows_train), ("toy-2dgs-train", half_rows_train),
    ("toy-3dgs-orbit", answer_altered), ("toy-2dgs-orbit", answer_altered),
    ("toy-3dgs-orbit", half_frame), ("toy-2dgs-orbit", half_frame),
    ("toy-3dgs-orbit", drops), ("toy-3dgs-train", drops),
])
def test_a_fault_in_the_timed_path_is_not_correct(root, cell, fault):
    res = go(root, cell, plant=fault)
    assert not res["correct"], res["checks"]
