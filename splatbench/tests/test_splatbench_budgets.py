"""The no-drop budget finder on the toy configurations."""

from __future__ import annotations

import pytest
import torch

from splatbench.harness import cells
from splatbench.harness.scene import load_scene
from splatbench.harness.spec import Spec
from splatbench.tests import toy
from splatbench.tools import budgets


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_budgets_hold_every_pose_and_no_more(tmp_path, family):
    root = toy.write_root(tmp_path)
    c = toy.config(family)
    raw = load_scene(toy.REPO / c["scene"]["file"], family, "cpu", c["scene"]["every"])
    cell = cells.build(Spec(f"toy-{family}-train", root), 1, torch.device("cpu"))
    orbit = dict(toy.ORBIT, yaw_step_deg=45.0)
    r = budgets.measure(c, [toy.TRAIN, orbit], raw, torch.device("cpu"), 2, 2, cell,
                        log=lambda *a: None)
    b, m = r["budgets"], r["maxima"]
    assert r["drops_at_budgets"] == 0 and r["poses_checked"] == 3 * 4 + 8
    assert m["tile_max"] <= b["tile_capacity"] < m["tile_max"] * budgets.ROOM + 64
    assert b["max_tile_span"] == m["widest"] + 2
    assert b["isect_padding_multiplier"] * raw["means3d"].shape[0] >= m["isects"] * budgets.ROOM
