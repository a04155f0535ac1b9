"""The toy cells on the card: built, run, traced and checked through the
port's CUDA kernels. Skipped where there is no card."""

from __future__ import annotations

import pytest
import torch

from splatbench import run
from splatbench.tests import toy


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["toy-3dgs-train", "toy-2dgs-train", "toy-3dgs-orbit",
                                  "toy-2dgs-orbit"])
def test_toy_cell_on_the_card(tmp_path, card, cell):
    root = toy.write_root(tmp_path)
    res = run.run_cell(cell, 2**31 + 99, 1.0, False, card, root=root)
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes"] > 0
    res = run.run_cell(cell, 2**31 + 98, 1.0, True, card, root=root)
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    kind = "train" if "train" in cell else "render"
    assert res["metrics"][f"launches.{kind}"]["value"] > 0
