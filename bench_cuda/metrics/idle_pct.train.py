"""The device's idle share of an untraced train step, in %: one less the
device's busy time a step in the traced window (the union of its operations'
intervals over the traced steps) over the untraced step time, measured just
before the trace. The traced window itself runs slower, its dispatch slowed
by the profiler, and would read more idle."""


def read(ctx):
    n, step_s = ctx.info.get("steps"), ctx.info.get("step_s")
    if not n or not step_s or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / n / step_s)
