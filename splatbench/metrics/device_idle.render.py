"""Share of the traced window of orbit frames with no operation on the
device, in per cent."""


def read(ctx):
    if ctx["kind"] != "orbit":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
