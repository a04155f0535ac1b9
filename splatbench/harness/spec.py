"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root names each cell (``workloads``), the file
of each configuration (``configs``) and each metric. Everything else is
found by name under ``<root>/splatbench/``:

  - a traffic mix: ``traffic/<traffic>.json``;
  - a per-layer metric's reader: ``metrics/<name>.py``, with a function
    ``read(ctx) -> float | None`` (None: nothing to read in this cell);
  - a cell's correctness check: ``checks/<workload>.json``, each number it
    compares with its limit (and the readings the limit was set from), and
    for a train cell ``checked_steps``, the first steps the reference
    follows.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits nothing here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


class Spec:
    """One cell of the benchmark rooted at ``root``."""

    def __init__(self, workload: str, root: Path = CHECKOUT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {self.root / 'BENCHMARK.json'}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        self.traffic = self.load("traffic", self.cell["traffic"], ".json")
        self.checks = self.load("checks", workload, ".json")

    @property
    def name(self) -> str:
        return self.cell["name"]

    def load(self, kind: str, name: str, suffix: str) -> dict:
        return json.loads((self.root / "splatbench" / kind / f"{name}{suffix}").read_text())

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones untraced, its
        per-layer ones traced."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.root / "splatbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"splatbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
