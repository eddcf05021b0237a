"""K3 (``fused_tmdm``, the TMDM step kernel) against its roofline."""
from bench_cuda.metrics._roofline import share
from bench_cuda.yardstick import k3_work


def read(ctx):
    return share(ctx, "fused_tmdm", k3_work)
