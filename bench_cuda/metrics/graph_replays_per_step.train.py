"""CUDA graph replays a train step: the program's ``train.graph_replays``
over ``train.steps``, counted over every step of the run. 1.0 where every
step is one replay; None where the program replays no graph."""
from bench_cuda.metrics._program import counters, ratio


def read(ctx):
    return ratio(counters(), "train.graph_replays", "train.steps")
