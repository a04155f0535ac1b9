"""The system under test, as the benchmark drives it: the PyTorch port's
own entry points (``render_gaussians``, ``render_surfels``,
``train.train_step``, ``train.train_step_surfel``), its cameras and its
render configuration, and its counters.

The port is imported here and nowhere else in the harness, when a cell is
built: a checkout that holds only the benchmark fails there.
"""

from __future__ import annotations

import contextlib

import torch


def port():
    import mojosplat_tpu_torch as pkg
    from mojosplat_tpu_torch import train
    return pkg, train


def camera(pose: dict, dev):
    pkg, _ = port()
    return pkg.Camera.create(R=pose["R"], T=pose["T"], H=pose["H"], W=pose["W"],
                             fx=pose["fx"], fy=pose["fy"], cx=pose["cx"], cy=pose["cy"],
                             near=pose["near"], far=pose["far"], device=dev)


def render_config(config: dict):
    pkg, _ = port()
    return pkg.RenderConfig(raster_impl="cuda", **config["render"])


class Tally:
    """Device-side sums of the drop counters (the binning's capacity and
    span drops, the blend's tile overflow: a render with any above 0 kept
    fewer slots than its image needs) over every render the cell makes,
    and the number of renders with a drop; nothing syncs until
    ``read``. While ``keep`` is set, each render's outputs and aux are
    kept for the check."""

    def __init__(self, dev):
        self.dropped = torch.zeros((), dtype=torch.int64, device=dev)
        self.failed = torch.zeros((), dtype=torch.int64, device=dev)
        self.keep = False
        self.kept: list = []

    def add(self, out, aux) -> None:
        d = aux.binning.capacity_overflow + aux.binning.span_truncated + aux.raster.tile_overflow
        self.dropped += d
        self.failed += (d > 0).to(torch.int64)
        if self.keep:
            self.kept.append((out, aux))

    def read(self) -> tuple[int, int]:
        return int(self.dropped), int(self.failed)


@contextlib.contextmanager
def counted(tally: Tally):
    """Route the train module's renders through ``tally``: each call asks
    the renderer for its aux (which adds one comparison over the
    gaussians, its visibility mask) and hands the caller what it asked
    for."""
    _, train = port()
    real = {"render_gaussians": train.render_gaussians, "render_surfels": train.render_surfels}

    def wrap(fn):
        def call(*args, **kw):
            asked = kw.get("return_aux", False)
            kw["return_aux"] = True
            out = fn(*args, **kw)
            tally.add(out[:-1], out[-1])
            if asked:
                return out
            return out[0] if len(out) == 2 else out[:-1]
        return call

    for name, fn in real.items():
        setattr(train, name, wrap(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(train, name, fn)
