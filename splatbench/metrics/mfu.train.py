"""Per cent of the window's time a training step that the step's whole needed
work takes at the chip's peaks: the larger of all its f32 operations over
67 TFLOP/s and all its bytes over 3.35 TB/s (the blend both ways, SH,
projection and Adam for the visible gaussians)."""

from splatbench.metrics import _work


def read(ctx):
    return _work.mfu(ctx, "train")
