"""The readers of the program's own spans and counters, through a traced run
of each tiny cell on the CPU: the window runs under a CPU profiler, and a
synthetic trace stands for the card's (it gives the kernel count). The CPU
has no CUDA events, so the chain's stream time reads None there and its test
plants one. Each reader gives None, without raising, where the program keeps
no such record, as the program before its spans and counters."""
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import SEED, kernel_arithmetic, tiny_cell
from bench_cuda import devtrace, harness, spec
from upgdm_tpu_torch.utils import profiling as P

KERNELS = 50
SWEEP = ("chain_update_ms.sweep", "prep_host_ms.sweep", "d2h_reads_per_chunk.sweep")
TRAIN = ("optimizer_host_ms.train", "sync_wait_ms.train", "host_syncs_per_step.train",
         "dispatch_us_per_kernel.train")


def _trace_run(self, fn, span_names):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    self.trace = devtrace.Trace([devtrace.Op("k", float(i), 1.0, "kernel") for i in range(KERNELS)],
                                [], (0.0, 1e6))


@pytest.fixture
def traced(monkeypatch):
    """(result, spans) of a traced tiny run of a cell."""
    monkeypatch.setattr(harness.Run, "trace_run", _trace_run)
    timer = P.phase_timer()

    def run(name):
        timer.reset()
        with kernel_arithmetic():
            result = harness.execute(tiny_cell(name), SEED, 0.5, True, "cpu", time.perf_counter())
        return result, timer.spans()

    yield run
    timer.reset()


def _ctx(name):
    return harness.ReadContext(spec.find_cell(name), devtrace.Trace([], [], (0.0, 1.0)), {}, None)


@pytest.mark.parametrize("name", ["nsdiff_sweep", "tmdm_sweep"])
def test_sweep_readers(traced, name):
    result, spans = traced(name)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    assert m["d2h_reads_per_chunk.sweep"] == 2.0
    prep = spans["upgdm.sweep.prep"]
    assert m["prep_host_ms.sweep"] == prep["self_s"] * 1e3 / prep["calls"] > 0
    assert "chain_update_ms.sweep" not in m  # no CUDA events on the CPU
    P.phase_timer()._stream_s["upgdm.chain.update"] = 0.019
    got = spec.reader("chain_update_ms.sweep").read(_ctx(name))
    assert got == pytest.approx(19.0 / spans["upgdm.chain"]["calls"])


def test_train_readers(traced):
    result, spans = traced("nsdiff_train")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    steps = spans["upgdm.train.step"]["calls"]
    assert steps == tiny_cell("nsdiff_train").traffic["trace_steps"]
    assert m["host_syncs_per_step.train"] == 1.0
    assert m["optimizer_host_ms.train"] == spans["upgdm.train.optimizer"]["self_s"] * 1e3 / steps
    assert m["sync_wait_ms.train"] == spans["upgdm.train.sync"]["host_s"] * 1e3 / steps
    host = spans["upgdm.train.step"]["host_s"] - spans["upgdm.train.sync"]["host_s"]
    assert m["dispatch_us_per_kernel.train"] == host * 1e6 / KERNELS
    assert all(m[k] > 0 for k in TRAIN)


@pytest.mark.parametrize("metric", SWEEP + TRAIN)
def test_reader_none_without_the_record(metric, monkeypatch):
    cell = "nsdiff_train" if metric in TRAIN else "nsdiff_sweep"
    P.phase_timer().reset()
    assert spec.reader(metric).read(_ctx(cell)) is None
    monkeypatch.delattr(P.PhaseTimer, "spans")
    monkeypatch.delattr(P, "counters")
    P.count("sweep.chunks")
    P.count("train.steps")
    assert spec.reader(metric).read(_ctx(cell)) is None
    P.phase_timer().reset()


def test_entries_name_their_readers():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SWEEP + TRAIN:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"] == (["nsdiff_train"] if name in TRAIN
                                  else ["nsdiff_sweep", "tmdm_sweep"])
