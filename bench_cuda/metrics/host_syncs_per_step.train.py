"""Blocking device-to-host reads a train step: the program's
``train.host_syncs`` over ``train.steps``, counted over every step of the
run."""
from bench_cuda.metrics._program import counters, ratio


def read(ctx):
    return ratio(counters(), "train.host_syncs", "train.steps")
