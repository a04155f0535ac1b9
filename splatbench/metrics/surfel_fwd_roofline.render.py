"""Per cent of the 2DGS blend forward's (B6, ``surfel_fwd_kernel`` without
the maps) device time that its bound needs, over the traced orbit frames."""

from splatbench.metrics import _work


def read(ctx):
    return _work.kernel_share(ctx, "2dgs", "orbit", "fwd", False, "surfel_fwd_kernel")
