"""Carry parameters and cameras across from the reference package.

Both take plain numpy arrays (``np.asarray`` of the reference package's
arrays), so the two packages compute on identical inputs.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .camera import Camera


def params_from_numpy(
    params: Mapping[str, np.ndarray], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """Parameter dict of numpy arrays -> tensors on ``device``, same dtypes.

    Always a copy: an optimizer that steps the tensors in place leaves the
    numpy arrays as they were."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device, copy=True)
        for k, v in params.items()
    }


def shard_from_numpy(
    params: Mapping[str, np.ndarray], rank: int, n: int, device: torch.device | str
) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s rows ``[rank * N / n, (rank + 1) * N / n)`` of every
    leaf, as tensors on ``device`` (the shards of ``parallel``'s ZeRO-1 and
    gaussian-sharded steps); raises unless n divides N."""
    rows = {}
    for k, v in params.items():
        N = np.shape(v)[0]
        if N % n:
            raise ValueError(f"{k}: N={N} rows do not split over {n} ranks")
        m = N // n
        rows[k] = np.asarray(v)[rank * m:(rank + 1) * m]
    return params_from_numpy(rows, device)


def set_grads_from_numpy(
    params: Mapping[str, torch.Tensor], grads: Mapping[str, np.ndarray]
) -> None:
    """Give each parameter the numpy gradient of the same name as its
    ``.grad``, so an optimizer steps on exactly the gradient the reference
    package's optimizer is fed."""
    for k, g in grads.items():
        p = params[k]
        p.grad = torch.from_numpy(np.ascontiguousarray(np.asarray(g))).to(p.device, p.dtype)


def camera_from_numpy(fields: Mapping[str, Any], device: torch.device | str) -> Camera:
    """Camera from the fields of a reference-package camera (R, T, H, W, fx,
    fy, cx, cy, near, far, and optionally dist, rs_vel, camera_model,
    shutter), given as numpy arrays or scalars."""
    arrays = {
        k: np.array(fields[k], np.float32)  # a writable copy
        for k in ("R", "T", "fx", "fy", "cx", "cy", "near", "far")
    }
    optional = {
        k: np.array(fields[k], np.float32)
        for k in ("dist", "rs_vel") if fields.get(k) is not None
    }
    return Camera.create(
        H=int(fields["H"]), W=int(fields["W"]), device=device,
        camera_model=fields.get("camera_model", "pinhole"),
        shutter=fields.get("shutter", "global"),
        **arrays, **optional,
    )
