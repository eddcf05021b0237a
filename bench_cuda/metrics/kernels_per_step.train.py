"""Device kernels a train step: the kernels of the traced window over its
steps."""


def read(ctx):
    n = ctx.info.get("steps")
    k = len(ctx.trace.kernels())
    return k / n if n and k else None
