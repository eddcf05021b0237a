"""The device's idle share of the traced window, in %."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 and ctx.trace.ops else None
