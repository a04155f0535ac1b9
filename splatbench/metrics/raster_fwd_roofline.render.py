"""Per cent of the 3DGS blend forward's (B1, ``raster_fwd_kernel``) device
time that its bound needs, over the traced orbit frames."""

from splatbench.metrics import _work


def read(ctx):
    return _work.kernel_share(ctx, "3dgs", "orbit", "fwd", False, "raster_fwd_kernel")
