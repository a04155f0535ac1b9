"""PyTorch port: multi-process start-up (``parallel.multihost``) and the
``train_colmap --multihost`` CLI, the counterparts of
tests/test_multihost_smoke.py and tests/test_sharding.py's
``init_multihost`` checks.

Two processes start through the MOJOSPLAT_* contract (gloo on the CPU)
and an ``all_reduce`` of rank + 1 gives 3 on both; nothing set is a no-op,
or with ``world_of_one`` a world of one; a partial set and ``require=True``
with no rendezvous raise. The CLI runs in two processes on the smallest capture of tests/torch_colmap_cases.py
for 2 steps: each rank trains its replica, and only rank 0 writes.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from mojosplat_tpu_torch.parallel import init_multihost, is_primary
from mojosplat_tpu_torch.parallel import multihost
from torch_colmap_cases import train_capture
from torch_parallel_cases import ROOT, TIMEOUT_S, free_port, run_world

ENVS = (multihost.ENV_COORD, multihost.ENV_NPROC, multihost.ENV_PID, "MASTER_ADDR",
        "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_two_process_init_and_all_reduce(tmp_path):
    results = run_world("allreduce", 2, tmp_path)
    for r, out in enumerate(results):
        assert float(out["sum"][0]) == 3.0, r
        assert int(out["world"]) == 2
        assert bool(out["primary"]) == (r == 0)


def test_single_process_noop(clean_env):
    assert init_multihost() is False
    assert is_primary()


def test_world_of_one(clean_env):
    """Nothing configured and ``world_of_one``: a gloo world of this
    process alone, which the scaling sweep runs in one process."""
    import torch.distributed as dist

    assert init_multihost(backend="gloo", world_of_one=True) is True
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert is_primary()
    finally:
        dist.destroy_process_group()
    assert init_multihost() is False


def test_partial_env_rejected(clean_env):
    clean_env.setenv(multihost.ENV_COORD, "localhost:1234")
    with pytest.raises(ValueError, match="set all three"):
        init_multihost()


def test_require_without_rendezvous_raises(clean_env):
    with pytest.raises(ValueError, match="needs a rendezvous"):
        init_multihost(require=True, backend="gloo")


def test_train_colmap_multihost_two_processes(tmp_path):
    capture = train_capture(tmp_path / "capture")
    env = dict(os.environ, MOJOSPLAT_COORDINATOR=f"127.0.0.1:{free_port()}",
               MOJOSPLAT_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        # Each rank is given its own out dir, to see which one writes.
        argv = ["--data", str(capture), "--steps", "2", "--multihost", "--device", "cpu",
                "--impl", "torch", "--downscale", "1", "--max-gaussians", "256",
                "--sh-degree", "0", "--save-every", "1", "--out-dir", str(tmp_path / f"out{r}")]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mojosplat_tpu_torch.examples.train_colmap", *argv],
            env=dict(env, MOJOSPLAT_PROCESS_ID=str(r)), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    assert (tmp_path / "out0" / "scene_final.ply").exists()
    assert (tmp_path / "out0" / "scene_000002.ply").exists()
    assert "Done: artifacts in" in outs[0]
    assert not Path(tmp_path / "out1").exists()
    assert "Done" not in outs[1] and "step" not in outs[1]
