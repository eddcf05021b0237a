"""The whole chunk's share of the H100's dense bf16 peak (989 TFLOP/s at
700 W): the matrix FLOPs a chunk needs by the frozen yardstick, times the
chunks of the traced window, over the window's seconds and the peak, in %."""
from bench_cuda.yardstick import PEAK_FLOPS, chunk_flops


def read(ctx):
    n = ctx.info.get("chunks")
    if not n or ctx.trace.window_s <= 0:
        return None
    fl = chunk_flops(ctx.config["reference"], ctx.config["net"], ctx.info["series_per_chunk"],
                     ctx.info["samples"])
    return 100.0 * fl * n / ctx.trace.window_s / PEAK_FLOPS["bfloat16"]
