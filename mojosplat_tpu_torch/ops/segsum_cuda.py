"""Deterministic segment sum (kernel B3): key-sorted columns per segment.

Port of ``mojosplat_tpu.ops.segsum_pallas.segment_sum_cols``:
``out[f, s] = sum of cols[f, i] over the rows i with keys[i] == s``, for
keys sorted ascending; rows with a key >= ``num_segments`` are dropped. It
is the adjoint of the packed slot gather (``raster_cuda.gather_tile_data``).
With ``perm``, sorted row i is column ``perm[i]`` of ``cols``, as a sort
that carries the payload (the reference's) would hand it over.

The wrapper runs the CUDA kernel (``csrc/segsum.cu``) on a CUDA tensor, in
one launch: a block finds its window of segments' rows in the sorted keys
itself, marks where each segment's run begins and ends, and each thread
sums its segment's rows in row order from 0.0f, for a group of at most
three fields, with no atomics, so the result is bitwise reproducible and
equal to the plain version on the CPU. A thread's time is its segment's
length, so the kernel suits keys without one heavy segment. On a CPU tensor
it runs the plain version, ``index_add_``, which on the CPU also adds in
row order. CUDA's ``index_add_`` adds with atomics in no fixed order, so
on the card the plain version serves only as a yardstick and never on the
path.
"""

from __future__ import annotations

import torch

from .. import _kernels


def segment_sum_cols_plain(cols: torch.Tensor, keys: torch.Tensor, num_segments: int,
                           perm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: (F, M) f32, (M,) int keys -> (F, num_segments)."""
    if perm is not None:
        cols = cols.index_select(1, perm)
    F = cols.shape[0]
    out = torch.zeros((F, num_segments + 1), dtype=torch.float32, device=cols.device)
    # Keys at or past num_segments land in a spare last column, dropped.
    out.index_add_(1, keys.to(torch.int64).clamp(0, num_segments), cols.to(torch.float32))
    return out[:, :num_segments]


def segment_sum_cols(cols: torch.Tensor, keys: torch.Tensor, num_segments: int,
                     perm: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the columns of ``cols`` (F, M) f32 by the sorted int32 ``keys``
    (M,) into (F, num_segments): into ``out`` where given (a contiguous
    (F, num_segments) f32 tensor, a view of a larger one allowed), which is
    returned. With ``perm`` ((M,) int64), sorted row i reads column
    ``perm[i]``. Counts a launch in ``segment_sum_cols.launches``."""
    if cols.device.type == "cpu":
        summed = segment_sum_cols_plain(cols, keys, num_segments, perm)
        return summed if out is None else out.copy_(summed)
    _kernels.require(cols, "cols", torch.float32, 2)
    _kernels.require(keys, "keys", torch.int32, 1)
    F, M = cols.shape
    if keys.shape[0] != M or keys.device != cols.device:
        raise ValueError(f"keys ({tuple(keys.shape)}, {keys.device}) must be ({M},) on "
                         f"{cols.device}")
    if perm is not None:
        _kernels.require(perm, "perm", torch.int64, 1)
        if perm.shape[0] != M or perm.device != cols.device:
            raise ValueError(f"perm ({tuple(perm.shape)}, {perm.device}) must be ({M},) on "
                             f"{cols.device}")
    if out is None:
        out = torch.empty((F, num_segments), dtype=torch.float32, device=cols.device)
    else:
        _kernels.require(out, "out", torch.float32, 2)
        if out.shape != (F, num_segments) or out.device != cols.device:
            raise ValueError(f"out ({tuple(out.shape)}, {out.device}) must be "
                             f"({F}, {num_segments}) on {cols.device}")
    _kernels.launch("segsum_launch", cols.device, cols.data_ptr(), F, M,
                    None if perm is None else perm.data_ptr(), keys.data_ptr(),
                    num_segments, out.data_ptr())
    segment_sum_cols.launches += 1
    return out


segment_sum_cols.launches = 0


def segsum_shape() -> dict:
    """B3's launch shape (``_kernels.launch_shape``): registers, shared
    bytes, local bytes, threads a block and resident blocks per SM. Builds
    the kernels; needs the card."""
    return _kernels.launch_shape("segsum_info")
