"""Deterministic segment sum (kernel B3): key-sorted columns per segment.

Port of ``mojosplat_tpu.ops.segsum_pallas.segment_sum_cols``:
``out[f, s] = sum of cols[f, i] over the rows i with keys[i] == s``, for
keys sorted ascending; rows with a key >= ``num_segments`` are dropped. It
is the adjoint of the packed slot gather (``raster_cuda.gather_tile_data``).

The wrapper runs the CUDA kernel (``csrc/segsum.cu``) on a CUDA tensor: one
thread per (field, segment) sums the segment's rows in order over bounds
from ``torch.searchsorted``, with no atomics, so the result is bitwise
reproducible. A thread's time is its segment's length, so the kernel suits
keys without one heavy segment. On a CPU tensor it runs the plain version, ``index_add_``,
which on the CPU also adds in row order. CUDA's ``index_add_`` adds with
atomics in no fixed order, so on the card the plain version serves only as
a yardstick and never on the path.
"""

from __future__ import annotations

import torch

from .. import _kernels


def segment_sum_cols_plain(cols: torch.Tensor, keys: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: (F, M) f32, (M,) int keys -> (F, num_segments)."""
    F = cols.shape[0]
    out = torch.zeros((F, num_segments + 1), dtype=torch.float32, device=cols.device)
    # Keys at or past num_segments land in a spare last column, dropped.
    out.index_add_(1, keys.to(torch.int64).clamp(0, num_segments), cols.to(torch.float32))
    return out[:, :num_segments]


def segment_sum_cols(cols: torch.Tensor, keys: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Sum the columns of ``cols`` (F, M) f32 by the sorted int32 ``keys``
    (M,) into (F, num_segments). Counts a launch in
    ``segment_sum_cols.launches``."""
    if cols.device.type == "cpu":
        return segment_sum_cols_plain(cols, keys, num_segments)
    _kernels.require(cols, "cols", torch.float32, 2)
    _kernels.require(keys, "keys", torch.int32, 1)
    if keys.device != cols.device:
        raise ValueError("cols and keys must be on one device")
    F, M = cols.shape
    if keys.shape[0] != M:
        raise ValueError(f"keys has {keys.shape[0]} entries for {M} columns")
    bounds = torch.searchsorted(
        keys, torch.arange(num_segments + 1, dtype=torch.int32, device=keys.device))
    out = torch.empty((F, num_segments), dtype=torch.float32, device=cols.device)
    _kernels.launch("segsum_launch", cols.device, cols.data_ptr(), F, M,
                    bounds.data_ptr(), num_segments, out.data_ptr())
    segment_sum_cols.launches += 1
    return out


segment_sum_cols.launches = 0
