"""Readings that a cell's correctness limits are set from, at the cell's
own size, in one process.

    python3 splatbench/tools/readings.py --workload 3dgs-train-1080p \\
        --seeds 11 12 13 --control-seeds 21 22 23 [--seconds 2] [--out FILE]

  - For each of ``--seeds``: a run of the cell as ``run.py`` makes it, with
    a short window, and the numbers it compares (the lower readings).
  - For each of ``--control-seeds``: the control, the plain reference in
    the program's place computed in bfloat16, the next precision below the
    configuration's float32, compared with the float32 reference on the
    same inputs (the upper readings).
  - For a train cell, on the control seeds also the fault that leaves half
    of each view's rows out of the loss, the mean taken over the rest,
    planted in the reference put in the program's place. (A step that
    leaves the state unchanged reads 1 by the update's measure and needs no
    run.)

Prints, and writes to ``--out``, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench.harness import cells  # noqa: E402
from splatbench.harness.spec import Spec  # noqa: E402


def program_readings(spec: Spec, seed: int, seconds: float, dev) -> dict:
    cell = cells.build(spec, seed, dev)
    cell.setup()
    w = cell.window(seconds)
    dropped, _ = cell.drops()
    cell.free()
    nums = cell.check()
    nums["dropped"] = dropped
    nums["units"] = w["units"]
    if cell.kind == "train":  # each leaf's norms, program and reference
        nums["leaves"] = {k: {"g1": [cell.readings["g1"][k], cell.want["g1"][k]],
                              "delta": [cell.readings["delta"][k], cell.want["delta"][k]]}
                          for k in cell.want["g1"]}
        nums["losses"] = [cell.readings["losses"], cell.want["losses"]]
    return nums


def half_rows(loss_fn):
    """The fault: the loss of the top half of the rows alone."""
    def loss(m, target, view):
        h = target.shape[0] // 2
        return loss_fn({k: v[:h] for k, v in m.items()}, target[:h], view)
    return loss


def control_readings(spec: Spec, seed: int, seconds: float, dev) -> dict:
    cell = cells.build(spec, seed, dev)
    cell.setup()
    cell.window(seconds)
    cell.free()
    out = {}
    if cell.kind == "train":
        want = cell.reference()
        out["control_bf16"] = cell.compare(cell.reference(torch.bfloat16), want)
        out["fault_half_rows"] = cell.compare(cell.reference(plant=half_rows), want)
    else:
        worst: dict = {}
        for k, _, _, _ in cell.readings:
            want = cell.reference(k)
            got = cell.reference(k, torch.bfloat16)
            nums = cell.compare_frame(got.maps["rgb"], got.maps["T"], got.num_isects, want)
            for name, v in nums.items():
                worst[name] = max(worst.get(name, 0.0), v)
        out["control_bf16"] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    spec = Spec(args.workload)
    report: dict = {"workload": args.workload, "program": {}, "control": {}}
    for s in args.seeds:
        t = time.perf_counter()
        report["program"][s] = program_readings(spec, s, args.seconds, dev)
        print(f"program seed {s} ({time.perf_counter() - t:.1f} s): "
              f"{json.dumps(report['program'][s])}", flush=True)
    for s in args.control_seeds:
        t = time.perf_counter()
        report["control"][s] = control_readings(spec, s, args.seconds, dev)
        print(f"control seed {s} ({time.perf_counter() - t:.1f} s): "
              f"{json.dumps(report['control'][s])}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
