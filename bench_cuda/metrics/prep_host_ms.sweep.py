"""Host milliseconds a chunk of the sweep's input preparation (the pad,
scale and float32 cast of ``_chunks``): the self time of the program's
``upgdm.sweep.prep`` spans in the traced window over their calls. Read
under the profiler, whose hooks slow the host."""
from bench_cuda.metrics._program import spans


def read(ctx):
    prep = spans().get("upgdm.sweep.prep")
    return prep["self_s"] * 1e3 / prep["calls"] if prep else None
