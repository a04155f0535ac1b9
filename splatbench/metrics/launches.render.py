"""Device kernels launched a frame of the orbit, over the traced window."""


def read(ctx):
    if ctx["kind"] != "orbit" or not ctx["units"]:
        return None
    return ctx["kernels"] / ctx["units"]
