"""The port's spans and counters (``upgdm_tpu_torch/utils/profiling.py``) on
the CPU: with no profiler recording a span checks once and records nothing;
under a profiler every span of the sweep, the reverse chain and the train
step records its calls, self and host seconds, and sits in the Chrome trace
with its layer's operators inside; the counters read two device reads a
chunk and one host sync a step; and no number the program computes changes.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_cuda.devtrace import WINDOW_SPAN
from bench_cuda.drivers import mpv_sweep as bench_sweep
from bench_cuda.drivers import train_step as bench_train
from upgdm_tpu_torch.eval import uncertainty as U
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.train.loop import make_train_step
from upgdm_tpu_torch.train.optimizers import make_optimizer
from upgdm_tpu_torch.utils import profiling as P
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
T = 5  # reverse steps: T - 1 posterior updates a chain
NET = dict(dataset_nf=1, windows=24, pred_len=12, label_len=12, rolling_length=6,
           diffusion_steps=T, scaler_type=None, d_model=16, n_heads=2, e_layers=1, d_layers=1,
           d_ff=16, p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=3, dropout=0.05,
           sampling_dtype="float32")
WINDOWS = np.random.default_rng(3).normal(size=(5, 2, 24, 1)).astype(np.float32)
CHUNK = 2
CHUNKS = 3  # 5 windows in chunks of 2, the last padded
STEPS = 3
SELECT = "NsDiff_model"

# each span the benchmark wraps around the program from outside, and its twin inside
TWINS = {"sweep.call": "upgdm.sweep", "sweep.dispatch": "upgdm.sweep.dispatch",
         "sweep.drain": "upgdm.sweep.drain", "sweep.backbone": "upgdm.backbone",
         "sweep.chain": "upgdm.chain", "sweep.reduce": "upgdm.reduce",
         "train.step": "upgdm.train.step", "train.forward": "upgdm.train.forward",
         "train.optimizer": "upgdm.train.optimizer"}
# calls of each program span in two sweeps (NsDiff, TMDM) and STEPS train steps
CALLS = {"upgdm.sweep": 2, "upgdm.sweep.prep": 2 * CHUNKS, "upgdm.sweep.dispatch": 2 * CHUNKS,
         "upgdm.sweep.drain": 2 * CHUNKS, "upgdm.backbone": 2 * CHUNKS,
         "upgdm.chain": 2 * CHUNKS, "upgdm.chain.update": 2 * CHUNKS * (T - 1),
         "upgdm.reduce": 2 * CHUNKS, "upgdm.train.step": STEPS, "upgdm.train.forward": STEPS,
         "upgdm.train.backward": STEPS, "upgdm.train.sync": STEPS,
         "upgdm.train.optimizer": STEPS}
# spans only the card opens: the replay of the train step's CUDA graph
CARD_ONLY = {"upgdm.train.replay"}


def _sweeps():
    out = []
    for cls, task in ((NsDiffModel, "NsDiff"), (TMDMModel, "TMDM")):
        model = cls(dict(NET, task_model=task), device="cpu")
        model.generator.manual_seed(11)
        out.append(U.fast_mpv_sweep(model, WINDOWS, NET["pred_len"], CHUNK, device="cpu"))
    return out


def _train():
    model = NsDiffModel(dict(NET, task_model="NsDiff"), train_model_select=SELECT, device="cpu")
    model.generator.manual_seed(5)
    opt = make_optimizer(dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5), model.net,
                         model.trainable_mask(SELECT))
    step = make_train_step(model, opt, SELECT)
    rng = np.random.default_rng(9)
    batches = rng.normal(size=(STEPS, 4, NET["windows"] + NET["pred_len"], 1))
    return [step(torch.as_tensor(b, dtype=torch.float32)) for b in batches]


def _run_all():
    return _sweeps(), _train()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.fixture
def timer():
    t = P.phase_timer()
    t.reset()
    yield t
    t.reset()


def test_off_path_records_nothing(timer, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span did more than check for the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _run_all()
    assert timer.spans() == {} and dict(timer.totals) == {}
    # one object a name, so a use allocates nothing
    assert P.annotate("upgdm.chain.update") is P.annotate("upgdm.chain.update")
    c = P.counters()
    assert c["sweep.chunks"] == 2 * CHUNKS and c["sweep.d2h_reads"] == 4 * CHUNKS
    assert c["train.steps"] == c["train.host_syncs"] == STEPS


def test_on_path_calls_self_time_and_counters(timer):
    _profiled(_run_all)
    spans = timer.spans()
    assert {n: s["calls"] for n, s in spans.items()} == CALLS
    for name, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["host_s"], name
        assert s["stream_s"] is None, name  # no CUDA events on the CPU
    assert spans["upgdm.sweep"]["self_s"] < spans["upgdm.sweep"]["host_s"]
    assert dict(timer.counts) == CALLS  # the JAX package's form holds the host totals
    c = P.counters()
    assert c["sweep.d2h_reads"] / c["sweep.chunks"] == 2.0
    assert c["train.host_syncs"] / c["train.steps"] == 1.0


def test_span_nests_closes_on_error_and_decorates(timer):
    outer, inner = P.annotate("outer"), P.annotate("inner")

    @outer
    def work():
        with inner:
            torch.ones(8).sum()
        raise ValueError

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            work()
    s = timer.spans()
    assert s["outer"]["calls"] == s["inner"]["calls"] == 1
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["host_s"] - s["inner"]["host_s"])
    assert timer._open == []
    assert work.__name__ == "work"


def test_spans_share_the_trace_clock(timer, tmp_path):
    with P.trace(str(tmp_path)):
        _run_all()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"].startswith("upgdm.")]  # torch's optimizer annotates itself too
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    assert {e["name"] for e in spans} == set(CALLS)

    def inside(name, op_like):
        for s in (e for e in spans if e["name"] == name):
            a, b = s["ts"], s["ts"] + s["dur"]
            if any(op_like in o["name"] and a <= o["ts"] and o["ts"] + o["dur"] <= b
                   for o in ops):
                return True
        return False

    expected = {"upgdm.sweep": "aten::", "upgdm.sweep.dispatch": "aten::",
                "upgdm.sweep.drain": "aten::to", "upgdm.backbone": "aten::linear",
                "upgdm.chain": "aten::", "upgdm.chain.update": "aten::mul",
                "upgdm.reduce": "aten::var", "upgdm.train.step": "aten::",
                "upgdm.train.forward": "aten::", "upgdm.train.backward": "aten::",
                "upgdm.train.sync": "aten::item", "upgdm.train.optimizer": "aten::"}
    for name, op_like in expected.items():
        assert inside(name, op_like), name
    phases = json.loads((tmp_path / "phases.json").read_text())
    assert {n: s["calls"] for n, s in phases["spans"].items()} == CALLS
    assert phases["counters"]["train.host_syncs"] == STEPS


def test_numbers_unchanged_under_the_profiler(timer):
    plain_sweeps, plain_losses = _run_all()
    traced_sweeps, traced_losses = _profiled(_run_all)
    assert plain_losses == traced_losses and all(np.isfinite(plain_losses))
    for (mpv_a, mean_a), (mpv_b, mean_b) in zip(plain_sweeps, traced_sweeps):
        np.testing.assert_array_equal(mpv_a, mpv_b)
        np.testing.assert_array_equal(mean_a, mean_b)


def test_span_names_apart_from_the_benchmarks():
    names = set()
    for path in (REPO / "upgdm_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r'annotate\("([^"]+)"\)', path.read_text()))
    assert names == set(CALLS) | CARD_ONLY
    bench_spans = set(bench_sweep.SPANS) | set(bench_train.SPANS)
    assert not names & (bench_spans | {WINDOW_SPAN})
    assert set(TWINS) == bench_spans and set(TWINS.values()) <= names
    assert all(n.startswith("upgdm.") for n in names)
