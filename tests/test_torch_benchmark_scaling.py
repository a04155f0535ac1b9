"""PyTorch port: the ``benchmark_scaling`` sweep on the CPU.

Two processes started through the MOJOSPLAT_* variables (gloo) sweep d = 1
and 2 over both pipelines at a small size: rank 0 prints one JSON line
per point with the reference CLI's keys, the mesh of each pipeline, and
the routed-vs-replicated line; rank 1 prints nothing. One process alone
runs a world of one. Each process runs one thread.
"""

import json
import os
import subprocess
import sys

from torch_parallel_cases import ROOT, TIMEOUT_S, free_port

ARGS = ["--gaussians", "256", "--height", "64", "--width", "64", "--iterations", "2",
        "--device", "cpu", "--impl", "torch", "--pipeline", "both"]


def points(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def run(n):
    """The sweep in n processes (n = 1: no MOJOSPLAT_* variables, a world of
    one); returns each process's output."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MOJOSPLAT_")}
    env.update(OMP_NUM_THREADS="1")
    if n > 1:
        env.update(MOJOSPLAT_COORDINATOR=f"127.0.0.1:{free_port()}",
                   MOJOSPLAT_NUM_PROCESSES=str(n))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mojosplat_tpu_torch.examples.benchmark_scaling",
         *(["--multihost"] if n > 1 else []), *ARGS],
        env=dict(env, MOJOSPLAT_PROCESS_ID=str(r)) if n > 1 else env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


def test_two_process_sweep():
    outs = run(2)
    got = points(outs[0])
    assert [(r["devices"], r["pipeline"]) for r in got] == [
        (1, "dp-sp"), (1, "gauss"), (2, "dp-sp"), (2, "gauss")]
    assert got[2]["mesh"] == {"data": 2, "tile": 1} and got[3]["mesh"] == {"gauss": 2}
    for r in got:
        assert set(r) == {"devices", "mesh", "pipeline", "step_ms", "pixels_per_s"}
        assert r["step_ms"] > 0 and r["pixels_per_s"] > 0
    assert "routed-vs-replicated @ 2 device(s)" in outs[0]
    assert points(outs[1]) == [] and "world=" not in outs[1]


def test_single_process_world_of_one():
    (out,) = run(1)
    assert [(r["devices"], r["pipeline"]) for r in points(out)] == [(1, "dp-sp"), (1, "gauss")]
    assert "world=1" in out
