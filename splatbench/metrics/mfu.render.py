"""Per cent of the window's time a frame that the frame's whole needed work
takes at the chip's peaks: the blend, SH and projection of the visible
gaussians."""

from splatbench.metrics import _work


def read(ctx):
    return _work.mfu(ctx, "orbit")
