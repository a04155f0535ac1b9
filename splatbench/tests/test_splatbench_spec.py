"""The benchmark's files: BENCHMARK.json against its contract, and every
part of a cell found by its name, also a toy cell added from files alone."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from splatbench.harness.spec import Spec
from splatbench.tests import toy

REPO = toy.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["splatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).exists() and c["file"].startswith("splatbench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        assert (REPO / "splatbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    spec = Spec(workload)
    assert spec.traffic["kind"] in ("train", "orbit")
    assert spec.config["family"] in ("3dgs", "2dgs")
    assert "dropped" in spec.checks and spec.checks["dropped"]["limit"] == 0
    e2e = [m["name"] for m in spec.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(True)
    for m in spec.metrics(True):
        assert callable(spec.reader(m["name"]))


def test_toy_cell_from_files_only(tmp_path: Path):
    """A configuration, two mixes, four cells, their limits and a metric,
    added as files and entries under another root, are found by name."""
    root = toy.write_root(tmp_path)
    spec = Spec("toy-2dgs-orbit", root)
    assert spec.config["scene"]["every"] == 4096
    assert spec.traffic == toy.ORBIT
    assert spec.checks == toy.ORBIT_LIMITS
    assert "toy_units" in [m["name"] for m in spec.metrics(True)]
    assert spec.reader("toy_units")({"units": 7}) == 7.0
    with pytest.raises(KeyError):
        Spec("no-such-cell", root)
