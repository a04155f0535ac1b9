"""Run one cell of the benchmark once, on the card, and print its result.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process is one run: it loads the cell's scene, sets up and warms up
the port on it, measures for ``--seconds``, checks what the measured path
produced against the plain reference, and prints one JSON line last on
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit, which also close standard error).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from a profiled window. Without a CUDA device it exits
with code 2 and prints no result; if JAX or the JAX package was loaded,
with code 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# The driver's PTX cache, if the device ever compiles one, stays in the checkout.
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "splatbench" / "cuda-cache"))
# One intra-op CPU thread: the host's path is the program's Python and its
# launches, and idle OpenMP workers spinning beside it made runs spread.
os.environ.setdefault("OMP_NUM_THREADS", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "mojosplat_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``mojosplat_tpu_torch`` is not ``mojosplat_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(xs: list[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, dev, root: Path = ROOT,
             plant=None) -> dict:
    """One run of a cell on ``dev``; returns the result line as a dict.
    ``plant`` puts a fault in the timed path (the harness's own tests)."""
    import torch

    from splatbench.harness import cells, trace as tr
    from splatbench.harness.spec import Spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    spec = Spec(workload, root)
    marks = {"imports": time.perf_counter() - T_PROCESS}
    cell = cells.build(spec, seed, dev, plant)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks["scene and program objects"] = time.perf_counter() - T_PROCESS
    marks.update({f"of which {k}": v for k, v in cell.marks.items()})
    cell.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_PROCESS
    marks["warm-up and checked steps"] = setup_s
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # CUDA activity only; a CPU run (the harness's tests) has none to record.
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            w = cell.window(seconds)
        tl = tr.timeline(tr.device_ops(prof))
        del prof
    else:
        w = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    dropped, failed = cell.drops()
    cell.free()

    nums = cell.check()
    nums["dropped"] = dropped
    # The cell's checks file names the numbers it compares, each with its limit.
    checks = {name: {"value": nums[name], "limit": c["limit"]}
              for name, c in spec.checks.items() if isinstance(c, dict)}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w["units"], "failed": failed}
    if not trace:
        values = {"setup_s": setup_s,
                  "train_steps_per_s": w["units"] / w["window_s"],
                  "render_fps": w["units"] / w["window_s"]}
        if getattr(cell, "latency", None):
            values["render_p95_ms"] = 1e3 * percentile(cell.latency, 0.95)
        for m in spec.metrics(False):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(kind=cell.kind, family=cell.family, units=w["units"], window_s=w["window_s"],
                   busy_s=tl.busy_s, kernels=tl.kernels, work=cells.pose_work(cell),
                   kernel_seconds=lambda frag: tr.kernel_seconds(tl, frag))
        for m in spec.metrics(True):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=tl.busy_s, window_s=w["window_s"])
        result["breakdown"] = tr.breakdown(tl)
    result.update(metrics=metrics, device=device, power=power_limit() if cuda else "cpu",
                  setup_marks_s=marks, checks=checks)
    return result


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from splatbench.harness.spec import Spec

    chips = Spec(args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"splatbench: loaded {', '.join(bad)}; the port must not", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
