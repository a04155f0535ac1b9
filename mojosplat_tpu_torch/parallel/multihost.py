"""Multi-process start-up: ``torch.distributed`` process groups.

Counterpart of ``mojosplat_tpu.parallel.multihost``. One process runs per
rank (one per card); call ``init_multihost()`` first thing in a CLI. It is
a no-op unless a multi-process run is configured, so every CLI stays
single-process by default.

Configuration, in this order:

  1. ``MOJOSPLAT_COORDINATOR`` (``host:port`` of rank 0),
     ``MOJOSPLAT_NUM_PROCESSES`` and ``MOJOSPLAT_PROCESS_ID``, all three
     or none: ``init_process_group(init_method="tcp://<coordinator>",
     world_size, rank)``;
  2. ``require=True`` with none of them set: ``init_method="env://"``, the
     variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
     ``WORLD_SIZE``, ``RANK``);
  3. nothing set and ``require=False``: no-op, or with ``world_of_one``
     a world of this process alone on a free local port.

The backend is NCCL, each rank on ``cuda:(LOCAL_RANK or rank) %
device_count``; gloo only when the caller asks for it (the CPU).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

ENV_COORD = "MOJOSPLAT_COORDINATOR"  # e.g. "10.0.0.2:8476"
ENV_NPROC = "MOJOSPLAT_NUM_PROCESSES"
ENV_PID = "MOJOSPLAT_PROCESS_ID"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_multihost(require: bool = False, backend: str | None = None,
                   world_of_one: bool = False) -> bool:
    """Initialise the default process group when configured; else no-op
    (or, with ``world_of_one``, a world of this process alone).

    Returns True when it initialised the group. ``backend``: None for NCCL
    on this rank's card (which it makes the current device), or a backend
    name (``"gloo"`` for CPU tensors)."""
    # Empty strings (an unexpanded shell variable) count as unset, so the
    # check below fails with its message rather than on int('').
    coord = os.environ.get(ENV_COORD) or None
    nproc = os.environ.get(ENV_NPROC) or None
    pid = os.environ.get(ENV_PID) or None
    if coord or nproc or pid:
        if not (coord and nproc and pid):
            raise ValueError(
                f"set all three of {ENV_COORD}, {ENV_NPROC}, {ENV_PID} "
                f"(got coord={coord!r}, nproc={nproc!r}, pid={pid!r})"
            )
        kwargs = dict(init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid))
    elif require:
        missing = [k for k in _TORCHRUN_ENV if not os.environ.get(k)]
        if missing:
            raise ValueError(
                f"a multi-process run needs a rendezvous: set {ENV_COORD}, {ENV_NPROC} and "
                f"{ENV_PID}, or launch under torchrun (unset: {', '.join(missing)})")
        kwargs = dict(init_method="env://")
    elif world_of_one:
        kwargs = dict(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    else:
        return False
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost: NCCL needs a CUDA device and none is available; "
                "pass backend='gloo' to run the ranks on the CPU")
        local = os.environ.get("LOCAL_RANK")
        rank = int(local) if local else kwargs.get("rank", int(os.environ.get("RANK", "0")))
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **kwargs)
    else:
        dist.init_process_group(backend, **kwargs)
    return True


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def is_primary() -> bool:
    """True on the process that prints, logs and writes files: rank 0, or
    the only process when no group is initialised."""
    return not dist.is_initialized() or dist.get_rank() == 0
