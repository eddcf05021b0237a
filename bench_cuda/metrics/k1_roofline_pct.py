"""K1 (``fused_denoiser``, the NsDiff step kernel) against its roofline."""
from bench_cuda.metrics._roofline import share
from bench_cuda.yardstick import k1_work


def read(ctx):
    return share(ctx, "fused_denoiser", k1_work)
