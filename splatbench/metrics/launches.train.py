"""Device kernels launched a training step: the launch path (the port's
kernel wrappers and ATen, from the render down), over the traced window."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return ctx["kernels"] / ctx["units"]
