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
    """Parameter dict of numpy arrays -> tensors on ``device``, same dtypes."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device)
        for k, v in params.items()
    }


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
