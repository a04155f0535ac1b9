"""Per cent of the 2DGS blend backward's (B8 with the maps,
``surfel_bwd_kernel``) device time that its bound needs, over the traced
training steps."""

from splatbench.metrics import _work


def read(ctx):
    return _work.kernel_share(ctx, "2dgs", "train", "bwd", True, "surfel_bwd_kernel")
