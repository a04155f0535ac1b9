"""Segment-slice gather (kernel B5): the dense per-tile slot table.

Port of ``mojosplat_tpu.ops.slice_pallas.segment_slice_gather``:
``out[t * cap + j] = src[starts[t] + j]`` for ``j < cap``, with reads at or
past the end of ``src`` giving 0, as the TPU version's zero padding does
(and reads before its start giving 0 too, where the TPU version takes
non-negative starts only).

The wrapper runs the CUDA kernel (``csrc/slice.cu``: a block per run of
one tile's slots, 16-byte stores where ``cap % 4 == 0``; words copied bit
for bit, so NaN payloads pass) on a CUDA tensor and the plain PyTorch
version below on a CPU tensor. ``cap`` is any positive int.
"""

from __future__ import annotations

import torch

from .. import _kernels

_FOUR_BYTE = (torch.int32, torch.float32)


def segment_slice_gather_plain(
    src: torch.Tensor, starts: torch.Tensor, cap: int
) -> torch.Tensor:
    """Plain PyTorch version: (M,), (n_tiles,) -> (n_tiles * cap,)."""
    M = src.shape[0]
    idx = starts.to(torch.int64)[:, None] + torch.arange(cap, device=src.device)
    idx = torch.where((idx >= 0) & (idx < M), idx, M)  # M: the zero pad
    padded = torch.cat([src, torch.zeros(1, dtype=src.dtype, device=src.device)])
    return padded[idx].reshape(-1)


def segment_slice_gather(src: torch.Tensor, starts: torch.Tensor, cap: int) -> torch.Tensor:
    """Cut ``cap`` entries per tile out of ``src`` (int32 or float32) at the
    tile's start. Counts a launch in ``segment_slice_gather.launches``."""
    if src.device.type == "cpu":
        return segment_slice_gather_plain(src, starts, cap)
    if src.dtype not in _FOUR_BYTE:
        raise ValueError(f"src must be int32 or float32, got {src.dtype}")
    _kernels.require(src, "src", src.dtype, 1)
    _kernels.require(starts, "starts", torch.int32, 1)
    if starts.device != src.device:
        raise ValueError("src and starts must be on one device")
    n_tiles = starts.shape[0]
    out = torch.empty((n_tiles * cap,), dtype=src.dtype, device=src.device)
    _kernels.launch("slice_gather_launch", src.device, src.data_ptr(), src.shape[0],
                    starts.data_ptr(), n_tiles, cap, out.data_ptr())
    segment_slice_gather.launches += 1
    return out


segment_slice_gather.launches = 0
