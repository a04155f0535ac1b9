"""The device timeline of a traced window, from ``torch.profiler``.

Only CUDA activity is recorded (CUPTI's buffer of kernels, copies and
sets), so the host's own path is not slowed by per-operator records.
"""

from __future__ import annotations

from typing import NamedTuple


class Op(NamedTuple):
    name: str
    start: float  # s, on the profiler's clock
    dur: float  # s
    kernel: bool  # a kernel launch (not a copy or a memset)


def short(name: str) -> str:
    """A kernel's name without its return type and its argument list."""
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        # cut the argument list: from its matching "("
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def device_ops(prof) -> list[Op]:
    """The device's operations in the profile, in start order."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        kernel = not e.name().startswith(("Memcpy", "Memset"))
        ops.append(Op(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9, kernel))
    ops.sort(key=lambda o: o.start)
    return ops


class Timeline(NamedTuple):
    ops: list
    busy_s: float  # union of the operations' intervals
    kernels: int
    by_name: dict  # short kernel name -> device seconds
    gaps: dict  # "<kernel before> -> <kernel after>" -> idle seconds


def timeline(ops: list[Op]) -> Timeline:
    busy, end, prev = 0.0, None, None
    gaps: dict = {}
    by_name: dict = {}
    for o in ops:
        by_name[short(o.name)] = by_name.get(short(o.name), 0.0) + o.dur
        stop = o.start + o.dur
        if end is None or o.start >= end:
            if end is not None:
                label = f"{short(prev.name)} -> {short(o.name)}"
                gaps[label] = gaps.get(label, 0.0) + (o.start - end)
            busy += o.dur
            end, prev = stop, o
        elif stop > end:
            busy += stop - end
            end, prev = stop, o
    return Timeline(ops, busy, sum(o.kernel for o in ops), by_name, gaps)


def kernel_seconds(tl: Timeline, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(o.dur for o in tl.ops if o.kernel and fragment in o.name)


def breakdown(tl: Timeline) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(tl.by_name), "idle_gaps": top(tl.gaps)}
