"""Host milliseconds a train step spent waiting on the card for the loss:
the host time of the program's ``upgdm.train.sync`` spans (the step's
``.item()``) in the traced window over its ``upgdm.train.step`` calls. Read
under the profiler, whose hooks slow the host, so the card waits longer and
the host less than in an untraced step."""
from bench_cuda.metrics._program import spans


def read(ctx):
    s = spans()
    sync, step = s.get("upgdm.train.sync"), s.get("upgdm.train.step")
    return sync["host_s"] * 1e3 / step["calls"] if sync and step else None
