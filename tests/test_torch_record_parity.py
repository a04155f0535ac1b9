"""PyTorch port: the parity recorder against ``scripts/record_parity.py``.

``family`` makes each of the three records on the CPU at 500 gaussians and
48x64, where the ``"cuda"`` route runs each kernel's plain version: its
fields are the reference record's (read from the reference's source), less
the bf16 gradient route, which the port does not have, plus the field
saying so; the routes agree within the kernels' rules. ``main`` keeps a
record taken at the same git revision and discards one from another, and
refuses to run off the card.
"""

import ast
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from mojosplat_tpu_torch import render_gaussians, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples import record_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 500, 48, 64
GRAD_KEYS = {"features", "means3d", "opacities", "quats", "scales"}


def reference_record_keys() -> set:
    """The keys of the dict that scripts/record_parity.py's family returns."""
    with open(os.path.join(REPO, "scripts", "record_parity.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "family")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].value.keys}


def params():
    raw = mtrain.init_gaussians(N, sh_degree=2, position_scale=2.0,
                                generator=torch.Generator().manual_seed(0), device="cpu")
    return mtrain.activate(raw)


@pytest.mark.parametrize("name", record_parity.FAMILIES)
def test_family_record_on_cpu(name):
    p = params()
    if name == "2dgs":
        rec = record_parity.family(render_surfels, dict(p, scales=p["scales"][:, :2]), 2,
                                   height=H, width=W)
    else:
        kw = dict(kw=record_parity.KW32) if name == "3dgs_ts32_tight" else {}
        rec = record_parity.family(render_gaussians, p, 2, height=H, width=W, **kw)
    want = reference_record_keys()
    assert "grad_max_rel_bf16_route" in want
    assert set(rec) == want - {"grad_max_rel_bf16_route"} | {"grad_bf16_route"}
    assert rec["grad_bf16_route"] == record_parity.GRAD_BF16_ROUTE
    assert set(rec["grad_max_rel_exact"]) == GRAD_KEYS
    assert 0.1 < rec["fwd_image_scale"] < 2.0
    # The plain kernels against the plain route: the B1 rule's largest
    # difference and share, and the B2 rule's largest relative gradient.
    assert rec["fwd_max_abs_diff"] <= 5e-3 and rec["fwd_p999_abs_diff"] <= 1e-5
    assert rec["fwd_pixels_above_1e5"] <= 1e-4 * H * W * 3
    assert all(0 <= v <= 1e-3 for v in rec["grad_max_rel_exact"].values())
    assert all(math.isfinite(v) for k, v in rec.items() if isinstance(v, float))


def test_load_record_keeps_only_the_same_revision(tmp_path, capsys):
    path = str(tmp_path / "parity.json")
    assert record_parity.load_record(path, "abc") == {}
    rec = {"git_rev": "abc", "3dgs": {"fwd_max_abs_diff": 1.0}}
    with open(path, "w") as f:
        json.dump(rec, f)
    assert record_parity.load_record(path, "abc") == rec
    assert record_parity.load_record(path, "def") == {}
    assert "discarding stale results" in capsys.readouterr().out


def test_main_resumes_at_the_same_revision(tmp_path, monkeypatch):
    monkeypatch.setattr(record_parity, "resolve_device", lambda name, impl: torch.device("cpu"))
    monkeypatch.setattr(record_parity, "device_line", lambda: "a test device")
    monkeypatch.setattr(record_parity, "git_rev", lambda: "rev-1")
    monkeypatch.setattr(record_parity, "N", N)
    monkeypatch.setattr(record_parity, "H", H)
    monkeypatch.setattr(record_parity, "W", W)
    path = tmp_path / "parity.json"
    kept = {"git_rev": "rev-1", "3dgs": {"kept": 1}, "2dgs": {"kept": 2}}
    path.write_text(json.dumps(kept))
    rec = record_parity.main([str(path)])
    assert rec["3dgs"] == {"kept": 1} and rec["2dgs"] == {"kept": 2}
    assert set(rec["3dgs_ts32_tight"]["grad_max_rel_exact"]) == GRAD_KEYS
    assert json.loads(path.read_text()) == rec
    assert rec["device"] == "a test device" and rec["workload"].startswith(f"{N} gaussians")

    monkeypatch.setattr(record_parity, "git_rev", lambda: "rev-2")
    rec = record_parity.main([str(path), "2dgs"])
    assert set(rec) == {"git_rev", "workload", "device", "note", "2dgs"}
    assert rec["git_rev"] == "rev-2" and "kept" not in rec["2dgs"]


def test_main_refuses_off_the_card(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        record_parity.main([str(tmp_path / "p.json"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        record_parity.main([str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()


def test_module_imports_no_jax():
    code = (
        "import sys\n"
        "import mojosplat_tpu_torch.examples.record_parity\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'mojosplat_tpu' or m.startswith('mojosplat_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
