"""What the benchmark may load: never JAX or the JAX package, and the
reference nothing of the port; and nothing without the port."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from splatbench import run
from splatbench.tests import toy

REPO = toy.REPO


def loaded_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r}); {code}; "
         "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=300, cwd=REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port_or_jax():
    mods = loaded_after("import splatbench.reference.render")
    assert not {"jax", "jaxlib", "flax", "mojosplat_tpu", "mojosplat_tpu_torch"} & set(mods)


def test_a_run_loads_no_jax():
    code = ("import tempfile, torch; from pathlib import Path; from splatbench import run; "
            "from splatbench.tests import toy; root = toy.write_root(Path(tempfile.mkdtemp())); "
            "r = run.run_cell('toy-3dgs-orbit', 7, 0.2, True, torch.device('cpu'), root=root); "
            "assert r['correct'] and not run.loaded_forbidden(), run.loaded_forbidden()")
    mods = loaded_after(code)
    assert "mojosplat_tpu_torch" in mods
    assert not {"jax", "jaxlib", "flax", "mojosplat_tpu"} & set(mods)


def test_forbidden_names_compare_whole(monkeypatch):
    assert run.loaded_forbidden() == [] or "mojosplat_tpu_torch" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "mojosplat_tpu_torch_extra", sys)
    assert "mojosplat_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "mojosplat_tpu.render", sys)
    assert {"jax", "mojosplat_tpu"} <= set(run.loaded_forbidden())


def test_sources_read_no_tpu_records():
    for path in (REPO / "splatbench").rglob("*.py"):
        if path.name == "test_splatbench_imports.py":
            continue
        text = path.read_text()
        for word in ("bench.py", "BENCH_r", "import jax", "from jax", "mojosplat_tpu."):
            assert word not in text, (path, word)


def test_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "splatbench/run.py", "--workload", "3dgs-orbit-1080p",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    code = ("import sys, torch; sys.path.insert(0, '.'); from splatbench import run; "
            "run.run_cell('3dgs-orbit-1080p', 1, 1, False, torch.device('cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
