"""Device milliseconds a chunk of the backbones (NsDiff's f(x) and g(x),
TMDM's conditional predictor): the kernels launched inside the benchmark's
``sweep.backbone`` spans of the traced window, over the number of spans."""


def read(ctx):
    n = ctx.trace.span_count("sweep.backbone")
    return ctx.trace.span_device_s("sweep.backbone") * 1e3 / n if n else None
