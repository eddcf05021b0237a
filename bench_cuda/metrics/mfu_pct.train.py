"""The whole train step's share of the H100's dense bf16 peak (989 TFLOP/s
at 700 W): forward and backward matrix FLOPs by the frozen yardstick over
the untraced step time of the traced run (``trace_steps`` steps together on
the host's clock, before the profiler starts) and the peak, in %."""
from bench_cuda.yardstick import PEAK_FLOPS, train_step_flops


def read(ctx):
    step_s = ctx.info.get("step_s")
    if not step_s:
        return None
    fl = train_step_flops(ctx.config["reference"], ctx.config["net"], ctx.info["batch"])
    return 100.0 * fl / step_s / PEAK_FLOPS["bfloat16"]
