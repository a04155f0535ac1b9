"""Observability: stage timing, kernel-build counting, structured logging.

Port of ``mojosplat_tpu.utils.metrics``. Times are fenced by
``torch.cuda.synchronize`` on the device of the outputs (the reference
fences with ``jax.block_until_ready``); CPU tensors need no fence.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("mojosplat_tpu_torch")


def _tensors(tree):
    """The tensors of a nested tuple/list/dict/NamedTuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _devices(tree) -> set:
    return {t.device for t in _tensors(tree)}


def _fence(tree):
    """Wait for the CUDA work that makes ``tree``'s tensors (a no-op for
    CPU tensors); returns ``tree``."""
    for dev in _devices(tree):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


@dataclass
class StageTimer:
    """Wall-clock timing per pipeline stage, each stage fenced on its
    outputs' devices."""

    times: dict[str, list] = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, outputs_holder: list | None = None):
        t0 = time.perf_counter()
        yield
        if outputs_holder:
            _fence(outputs_holder)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _fence(out)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "min_ms": 1e3 * min(ts),
                "max_ms": 1e3 * max(ts),
                "count": len(ts),
            }
        return out


def amortized_ms(fn, args, iters: int = 20) -> float:
    """Per-call time of ``fn(*args)`` in milliseconds, the host's launch
    path overlapped.

    On CUDA tensors (the device comes from ``args``): ``iters`` calls queued
    back to back between two CUDA events, less one call timed the same
    way, over ``iters - 1``; with CPU tensors the same on ``perf_counter``.
    One untimed call first (kernel builds, allocator warm-up). A stall of
    the host (a preemption, another process) only adds time; where one in
    the single call's reading makes it the longer, the difference means
    nothing, and the ``iters`` calls' mean is returned instead.
    """
    if iters < 2:
        raise ValueError(f"iters must be at least 2, got {iters}")
    cuda = [d for d in _devices(args) if d.type == "cuda"]
    fn(*args)
    if cuda:
        dev = cuda[0]

        def timed(n):
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end)
    else:
        def timed(n):
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            return (time.perf_counter() - t0) * 1e3

    t1 = timed(1)
    tn = timed(iters)
    return (tn - t1) / (iters - 1) if tn > t1 else tn / iters


def compilation_count() -> int:
    """The recompile counter: the builds and loads of the CUDA kernel
    library in this process (``_kernels.build`` compiling with nvcc, and
    ``_kernels.library`` loading the result). 0 until a kernel launches;
    at most 2 after. A scene change or another image size must not grow
    this: the kernels take shapes as arguments."""
    from .. import _kernels

    return _kernels.compiles + _kernels.loads


def log_render_aux(aux, step: int | None = None) -> dict:
    """Structured per-render metric dict from ``RenderAux``; logs a warning
    on an overflow."""
    rec = {
        "num_isects": int(aux.binning.num_isects),
        "isect_capacity_overflow": int(aux.binning.capacity_overflow),
        "tile_span_truncated": int(aux.binning.span_truncated),
        "tile_capacity_overflow": int(aux.raster.tile_overflow),
    }
    if step is not None:
        rec["step"] = step
    if rec["isect_capacity_overflow"] or rec["tile_capacity_overflow"]:
        logger.warning("render overflow: %s", rec)
    else:
        logger.debug("render metrics: %s", rec)
    return rec
