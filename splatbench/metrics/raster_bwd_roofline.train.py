"""Per cent of the 3DGS blend backward's (B2, ``raster_bwd_kernel``) device
time that its bound needs, over the traced training steps."""

from splatbench.metrics import _work


def read(ctx):
    return _work.kernel_share(ctx, "3dgs", "train", "bwd", False, "raster_bwd_kernel")
