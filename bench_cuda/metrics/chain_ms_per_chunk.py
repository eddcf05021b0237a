"""Device milliseconds a chunk of the reverse chain (``sample_chain``: the
step kernel and the chain's arithmetic between its calls): the kernels
launched inside the ``sweep.chain`` spans of the traced window, over the
number of spans."""


def read(ctx):
    n = ctx.trace.span_count("sweep.chain")
    return ctx.trace.span_device_s("sweep.chain") * 1e3 / n if n else None
