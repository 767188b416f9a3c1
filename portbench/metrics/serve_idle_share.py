"""The share of the traced stretch of serving in which no operation ran on
the device: 1 - the union of the device's operations over the window."""


def read(ctx):
    if ctx.trace.window_s <= 0.0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
