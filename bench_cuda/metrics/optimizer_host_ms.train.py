"""Host milliseconds a train step in the optimizer's step: the self time of
the program's ``upgdm.train.optimizer`` spans in the traced window over its
``upgdm.train.step`` calls. Read under the profiler, whose hooks slow the
host."""
from bench_cuda.metrics._program import spans


def read(ctx):
    s = spans()
    opt, step = s.get("upgdm.train.optimizer"), s.get("upgdm.train.step")
    return opt["self_s"] * 1e3 / step["calls"] if opt and step else None
