"""The reader of ``graph_replays_per_step.train``: the program's
``train.graph_replays`` over ``train.steps``, and None where the program
counts no replays (the CPU's eager step, or a program without the
counter)."""
import pytest

from bench_cuda import devtrace, harness, spec
from upgdm_tpu_torch.utils import profiling as P

METRIC = "graph_replays_per_step.train"


def _read():
    ctx = harness.ReadContext(spec.find_cell("nsdiff_train"),
                              devtrace.Trace([], [], (0.0, 1.0)), {}, None)
    return spec.reader(METRIC).read(ctx)


@pytest.fixture
def counters():
    P.phase_timer().reset()
    yield
    P.phase_timer().reset()


@pytest.mark.parametrize("replays,steps", [(8, 8), (7, 8)])
def test_reads_replays_over_steps(counters, replays, steps):
    P.count("train.graph_replays", replays)
    P.count("train.steps", steps)
    assert _read() == replays / steps


def test_none_without_the_counter(counters, monkeypatch):
    assert _read() is None
    P.count("train.steps", 8)
    assert _read() is None  # an eager step counts no replay
    monkeypatch.delattr(P, "counters")
    P.count("train.graph_replays", 8)
    assert _read() is None


def test_entry():
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[METRIC]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "replays/step", "higher", "program_counter", "train step", "train_step_ms",
        ["nsdiff_train"])
