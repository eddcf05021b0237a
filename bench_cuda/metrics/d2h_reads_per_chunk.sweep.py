"""Blocking device-to-host reads a chunk of the sweep: the program's
``sweep.d2h_reads`` over ``sweep.chunks``, counted over every call of the
run."""
from bench_cuda.metrics._program import counters, ratio


def read(ctx):
    return ratio(counters(), "sweep.d2h_reads", "sweep.chunks")
