"""Checkpointing of a training state with ``torch.save``.

Counterpart of ``mojosplat_tpu.utils.checkpoint`` (Orbax there). A state is
a nested dict of tensors, Python numbers and strings: the raw parameters,
the optimizers' ``state_dict()``s, the density-control statistics, the
step and a generator's ``get_state()``. It is written atomically (to
``<path>.tmp``, then renamed over ``path``) and read back with
``torch.load(weights_only=True)``, which loads tensors and plain
containers only.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, state: dict[str, Any]) -> None:
    """Write ``state`` to ``path``: a reader sees the old file or the new
    one, never a partial write."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, device: torch.device | str | None = None) -> dict[str, Any]:
    """The state saved by ``save_checkpoint``, its tensors on ``device``
    (where they were saved when None)."""
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)
