"""Segment expansion (kernel B4): per-slot rows from per-gaussian rows.

Port of ``mojosplat_tpu.ops.expand_pallas.segment_expand_offsets``. Slot s
belongs to the gaussian w with ``offsets[w] <= s < offsets[w + 1]``, where
``offsets`` (row 0 of ``fields``) is the exclusive prefix sum of the
per-gaussian slot counts; the result's column s is that gaussian's column
of ``fields``. Only slots below the total slot count have an owner; the
rest read the last gaussian's row, as the TPU kernel's do, and the caller
masks them.

The wrapper runs the CUDA kernel (``csrc/expand.cu``) on a CUDA tensor and
the plain PyTorch version below on a CPU tensor. Fields are int32, so
ownership is exact at any capacity.
"""

from __future__ import annotations

import torch

from .. import _kernels


def segment_expand_offsets_plain(fields: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain PyTorch version: (F, N) int32 -> (F, capacity) int32."""
    F, N = fields.shape
    slots = torch.arange(capacity, dtype=fields.dtype, device=fields.device)
    owner = torch.searchsorted(fields[0].contiguous(), slots, right=True) - 1
    if N == 0:
        return torch.zeros((F, capacity), dtype=fields.dtype, device=fields.device)
    rows = fields[:, owner.clamp(min=0)]
    return torch.where(owner >= 0, rows, torch.zeros_like(rows))


def segment_expand_offsets(fields: torch.Tensor, capacity: int) -> torch.Tensor:
    """Expand (F, N) int32 per-gaussian rows to (F, capacity) per-slot rows.

    Row 0 of ``fields`` must be non-decreasing (the exclusive prefix sum of
    slot counts). Counts a launch in ``segment_expand_offsets.launches``.
    """
    if fields.device.type == "cpu":
        return segment_expand_offsets_plain(fields, capacity)
    _kernels.require(fields, "fields", torch.int32, 2)
    F, N = fields.shape
    out = torch.empty((F, capacity), dtype=torch.int32, device=fields.device)
    _kernels.launch("expand_offsets_launch", fields.device,
                    fields.data_ptr(), F, N, out.data_ptr(), capacity)
    segment_expand_offsets.launches += 1
    return out


segment_expand_offsets.launches = 0
