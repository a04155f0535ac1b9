#!/usr/bin/env python3
"""What one projection call does on the host and on the card.

For each mode (``ewa``, ``ut``) and count (``--gaussians``), on
``examples/benchmark_proj``'s data and camera at 1920x1080, it runs a few
untimed calls of ``project_gaussians``, then:

  - ``amortized_ms``: ``utils.metrics.amortized_ms`` of the call, as
    ``benchmark_proj`` reads it (calls queued back to back);
  - ``host_ms``: the median host time of one call, from the call to its
    return (no synchronize inside), over 20 calls each started on an
    idle card;
  - from one call under ``utils.profiling.trace`` (CPU and CUDA
    activities), inside a ``projection`` span: the kernel launches
    (``cudaLaunchKernel`` and ``cuLaunchKernel``), the device kernels and
    their summed time (one stream: the device busy time), the host-device
    copies (runtime ``cudaMemcpy*`` calls, their host time), the syncs
    (``cuda*Synchronize`` calls, their host time), the host time in all
    runtime calls, and the span's own host time.

It prints one line per (mode, count) and, as its last line, the same
numbers as one JSON object, with the card's name and power limit. Run from
the repository root:

    python3 scripts/port_projection_trace.py [--gaussians 1000 100000 1000000]

Needs a CUDA card (``--device cpu`` counts the host side only, for a dry
run). It imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mojosplat_tpu_torch import RenderConfig  # noqa: E402
from mojosplat_tpu_torch.examples.benchmark_proj import (create_camera,  # noqa: E402
                                                         generate_gaussian_data)
from mojosplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from mojosplat_tpu_torch.utils.metrics import amortized_ms  # noqa: E402
from mojosplat_tpu_torch.utils.profiling import annotate, trace  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SPAN = "projection"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def read_trace(path: str) -> dict:
    """The counts and times of the events inside the ``projection`` span
    of a Chrome trace (times in ms)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and t0 <= e["ts"] <= t1]
    launch_ids = {e["args"].get("correlation") for e in runtime if e["name"] in LAUNCHES}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launch_ids]
    copies = [e for e in runtime if e["name"].startswith("cudaMemcpy")]
    syncs = [e for e in runtime if e["name"].endswith("Synchronize")]
    ms = lambda evs: sum(e["dur"] for e in evs) / 1e3  # noqa: E731
    return dict(span_ms=span["dur"] / 1e3, launches=len(launch_ids), kernels=len(kernels),
                kernel_ms=ms(kernels), copies=len(copies), copy_host_ms=ms(copies),
                syncs=len(syncs), sync_host_ms=ms(syncs), runtime_calls=len(runtime),
                runtime_host_ms=ms(runtime),
                launch_host_ms=ms([e for e in runtime if e["name"] in LAUNCHES]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, nargs="+", default=[1_000, 100_000, 1_000_000])
    ap.add_argument("--modes", nargs="+", default=["ewa", "ut"], choices=["ewa", "ut"])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("port_projection_trace: no CUDA device")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, check=True).stdout.strip()
    else:
        smi = "cpu"
    print(smi, flush=True)
    cam = create_camera(args.height, args.width, device=dev)
    rows = []
    for n in args.gaussians:
        data = generate_gaussian_data(n, device=dev)
        for mode in args.modes:
            cfg = RenderConfig(projection_mode=mode)

            def proj(m, s, q, o):
                with torch.no_grad():
                    return project_gaussians(m, s, q, o, cam, cfg)

            for _ in range(3):
                proj(*data)
            amortized = amortized_ms(proj, data, 20)
            host = []
            for _ in range(20):
                sync(dev)
                t = time.perf_counter()
                proj(*data)
                host.append((time.perf_counter() - t) * 1e3)
            sync(dev)
            with tempfile.TemporaryDirectory() as d:
                with trace(d, dev):
                    with annotate(SPAN):
                        proj(*data)
                    sync(dev)
                row = dict(mode=mode, n=n, amortized_ms=amortized,
                           host_ms=statistics.median(host),
                           **read_trace(os.path.join(d, "trace.json")))
            rows.append(row)
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)
    print(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
