"""The control at a size a test run holds: the plain reference computed in
bfloat16, put in the program's place, reads over the toy cells' limits,
while the program reads under them. At the cells' own sizes the same
readings come from ``splatbench/tools/readings.py`` on the card."""

from __future__ import annotations

import pytest
import torch

from splatbench.harness.spec import Spec
from splatbench.tests import toy
from splatbench.tools import readings


@pytest.mark.parametrize("cell", ["toy-3dgs-train", "toy-2dgs-train", "toy-3dgs-orbit",
                                  "toy-2dgs-orbit"])
def test_control_fails_where_the_program_passes(tmp_path, cell):
    spec = Spec(cell, toy.write_root(tmp_path))
    dev = torch.device("cpu")
    limits = {k: v["limit"] for k, v in spec.checks.items() if isinstance(v, dict)}
    prog = readings.program_readings(spec, 11, 0.2, dev)
    assert all(prog[k] <= limits[k] for k in limits if k in prog), prog
    ctl = readings.control_readings(spec, 11, 0.2, dev)
    over = [k for k in limits if ctl["control_bf16"].get(k, 0) > limits[k]]
    assert over, ctl
    if "fault_half_rows" in ctl:
        assert any(ctl["fault_half_rows"].get(k, 0) > limits[k] for k in limits)
