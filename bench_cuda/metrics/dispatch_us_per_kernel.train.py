"""Host microseconds a launched kernel in the train step: the host time of
the program's ``upgdm.train.step`` spans less their ``upgdm.train.sync``
(the wait for the loss) in the traced window, over the kernels of the
window's trace. Read under the profiler, whose hooks slow the host's
dispatch."""
from bench_cuda.metrics._program import spans


def read(ctx):
    s = spans()
    step, sync = s.get("upgdm.train.step"), s.get("upgdm.train.sync")
    kernels = len(ctx.trace.kernels()) if ctx.trace is not None else 0
    if not step or not sync or not kernels:
        return None
    return (step["host_s"] - sync["host_s"]) * 1e6 / kernels
