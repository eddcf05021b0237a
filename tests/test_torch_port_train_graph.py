"""The train step's routes: eager on the CPU, one CUDA graph a step shape on
the card (``train/loop.py::make_train_step``).

On the CPU the step is the eager step it always was, bit for bit. The graph
route's logic (capture at the first call, replay at its shapes, the eager
body at any other, the warm-up that leaves weights, state and generator as
it found them, the fallback where capture fails) runs here with a stand-in
for the CUDA graph that replays by calling the captured body. The device
guard of the fused Adam runs on CPU tensors. The ``card`` cases hold real
replays against the eager step on a CUDA device, and every family's loss
trained for an epoch through ``run_training`` replayed against eager; they
skip without a card. On the card (whose machine has no JAX, which
``tests/conftest.py`` imports):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_train_graph.py -m card
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.train import loop
from upgdm_tpu_torch.train.loop import make_train_step, run_training
from upgdm_tpu_torch.train.optimizers import make_optimizer
from upgdm_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = dict(
    dataset_nf=2, windows=16, pred_len=8, rolling_length=4, diffusion_steps=5,
    scaler_type=None, d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
    p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=2, task_model="NsDiff",
    dropout=0.1, sampling_dtype="float32",
)
ADAM = dict(optimizer_name="Adam", lr=1e-2, weight_decay=1e-3)
GRAPH_COUNTERS = ("train.graph_captures", "train.graph_replays", "train.graph_fallbacks")


def _batch(B, seed, device="cpu"):
    """[B, windows + pred_len, N]: a random walk around 1."""
    rng = np.random.default_rng(seed)
    L = NS["windows"] + NS["pred_len"]
    walk = (rng.normal(size=(B, L, NS["dataset_nf"])) * 0.1).cumsum(axis=1) + 1.0
    return torch.as_tensor(walk.astype(np.float32), device=device)


def _model(device="cpu"):
    model = NsDiffModel(NS, seed=3, device=device)
    model.generator.manual_seed(5)
    return model


def _fused(model):
    """The card's optimizer (fused Adam, state on its device) over every
    parameter of ``model``."""
    params = [p for p in model.net.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=torch.tensor(ADAM["lr"]),
                            weight_decay=ADAM["weight_decay"], fused=True, capturable=True)


def _nan_on(model, calls):
    """The training loss NaN on the given train calls (1-based)."""
    loss_fn, n = model.loss_fn, [0]

    def wrapped(batch, select=None, train=True, **kw):
        out = loss_fn(batch, select=select, train=train, **kw)
        if train:
            n[0] += 1
            if n[0] in calls:
                out = out * float("nan")
        return out

    model.loss_fn = wrapped


def _stand_in_graph(warm, run, generator):
    """A CUDA graph's protocol on the CPU: the warm-up at capture, the
    captured body called again at each replay into the static output."""
    warm()
    out = torch.zeros(())
    return (lambda: out.copy_(run())), out


def _state(model, opt):
    weights = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    moments = [{k: v.clone() for k, v in opt.state[p].items()}
               for g in opt.param_groups for p in g["params"] if p in opt.state]
    return weights, moments


def _assert_same(a, b):
    (wa, ma), (wb, mb) = a, b
    assert wa.keys() == wb.keys()
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k
    assert len(ma) == len(mb)
    for sa, sb in zip(ma, mb):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.fixture
def counters():
    timer = profiling.phase_timer()
    timer.reset()
    yield lambda: {k: v for k, v in profiling.counters().items() if k in GRAPH_COUNTERS}
    timer.reset()


# -- the CPU route: today's eager step -----------------------------------------------

def _todays_step(model, optimizer):
    """The eager step as it stands on the CPU: zero the gradients, the loss
    and its backward, the loss read on the host, and the update only where
    that value is finite."""
    group = optimizer.param_groups[0]
    group.setdefault("applied_updates", 0)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss_fn(batch, select=None, train=True)
        loss.backward()
        value = loss.item()
        if math.isfinite(value):
            optimizer.step()
            group["applied_updates"] += 1
        return value

    return step


def test_cpu_step_is_todays_eager_step_bit_for_bit(counters):
    runs = []
    for build in (make_train_step, lambda m, o, s: _todays_step(m, o)):
        model = _model()
        _nan_on(model, {2})
        opt = make_optimizer(ADAM, model.net, model.trainable_mask())
        assert not loop._guards_on_device(opt)
        step = build(model, opt, None)
        losses = [step(_batch(4, s)) for s in range(4)]
        runs.append((losses, _state(model, opt), opt.param_groups[0]["applied_updates"]))
    (la, sa, na), (lb, sb, nb) = runs
    np.testing.assert_array_equal(la, lb)
    assert math.isnan(la[1]) and na == nb == 3
    _assert_same(sa, sb)
    assert counters() == {}


def test_cpu_run_training_records_are_todays(tmp_path, monkeypatch):
    data = _batch(10, 7).numpy()
    train = dict(train_model_select="NsDiff_model", train_batch_size=4, val_batch_size=4,
                 train_epochs=2, test_set=True, ckpt=False)

    def records(name):
        return run_training(data, data[:4], train, dict(NS), {}, ADAM, tmp_path / name,
                            seed=1, device="cpu")

    now = records("now")
    monkeypatch.setattr(loop, "make_train_step", lambda m, o, s, lr_at=None: _todays_step(m, o))
    assert records("today") == now


# -- the graph route, with a stand-in for the CUDA graph ---------------------------------

def _steps(graph, batches, monkeypatch, nan_on=(), lr_at=None, fail=False):
    """(losses, state, applied updates) of the fused optimizer's step over
    ``batches``, through the stand-in graph or eagerly."""
    model = _model()
    if nan_on:
        _nan_on(model, set(nan_on))
    opt = _fused(model)
    with monkeypatch.context() as m:
        m.setattr(loop, "_on_card", lambda o: graph)
        if fail:
            def refuse(warm, run, generator):  # the check's pass raised halfway
                warm()
                model.generator.manual_seed(99)
                return None
            m.setattr(loop, "_cuda_graph", refuse)
        else:
            m.setattr(loop, "_cuda_graph", _stand_in_graph)
        m.setattr(loop, "_signature", lambda b, kw: (tuple(b.shape),))
        step = make_train_step(model, opt, None, lr_at)
        losses = [step(b) for b in batches]
    return losses, _state(model, opt), opt.param_groups[0]["applied_updates"], opt


def test_fixed_shape_replays_and_ragged_runs_eager(monkeypatch, counters):
    batches = [_batch(4, 0), _batch(4, 1), _batch(3, 2), _batch(4, 3), _batch(4, 4)]
    eager = _steps(False, batches, monkeypatch)
    assert counters() == {}
    graphed = _steps(True, batches, monkeypatch)
    assert counters() == {"train.graph_captures": 1, "train.graph_replays": 4}
    np.testing.assert_array_equal(graphed[0], eager[0])
    _assert_same(graphed[1], eager[1])
    assert graphed[2] == eager[2] == 5


def test_host_sync_in_the_body_falls_back_to_eager(monkeypatch, counters):
    batches = [_batch(4, s) for s in range(3)]
    eager = _steps(False, batches, monkeypatch)
    with pytest.warns(UserWarning, match="runs eagerly"):
        fell_back = _steps(True, batches, monkeypatch, fail=True)
    assert counters() == {"train.graph_fallbacks": 1}
    np.testing.assert_array_equal(fell_back[0], eager[0])
    _assert_same(fell_back[1], eager[1])


def test_lr_schedule_is_written_into_the_graphs_rate(monkeypatch, counters):
    batches = [_batch(4, s) for s in range(4)]
    batches[1] = torch.full_like(batches[1], float("nan"))
    lr_at = lambda n: 1e-2 * 0.5 ** n
    eager = _steps(False, batches, monkeypatch, lr_at=lr_at)
    graphed = _steps(True, batches, monkeypatch, lr_at=lr_at)
    np.testing.assert_array_equal(graphed[0], eager[0])
    _assert_same(graphed[1], eager[1])
    lr = graphed[3].param_groups[0]["lr"]
    assert torch.is_tensor(lr) and float(lr) == pytest.approx(1e-2 * 0.5 ** 2)
    assert graphed[2] == 3 and counters()["train.graph_replays"] == 4


def test_signature_sends_host_inputs_eager():
    cpu = torch.zeros(2, 3)
    assert loop._signature(cpu, {}) is None
    assert loop._signature(cpu.numpy(), {}) is None
    assert loop._signature(torch.empty(2, 3, device="meta"), {}) is None


# -- the device guard on CPU tensors ---------------------------------------------------

def test_device_guard_leaves_state_on_a_nonfinite_loss():
    model = _model()
    _nan_on(model, {2})
    opt = _fused(model)
    step = make_train_step(model, opt, None)
    assert loop._guards_on_device(opt) and not loop._on_card(opt)
    assert np.isfinite(step(_batch(4, 0)))
    before = _state(model, opt)
    assert math.isnan(step(_batch(4, 1)))
    _assert_same(_state(model, opt), before)
    assert all(float(opt.state[p]["step"]) == 1.0 for p in opt.state)
    assert opt.param_groups[0]["applied_updates"] == 1
    assert np.isfinite(step(_batch(4, 2)))
    assert opt.param_groups[0]["applied_updates"] == 2
    assert all(float(opt.state[p]["step"]) == 2.0 for p in opt.state)


def test_device_guarded_update_is_torch_adams():
    runs = []
    for make in (_fused, lambda m: make_optimizer(ADAM, m.net, m.trainable_mask())):
        model = _model()
        opt = make(model)
        step = make_train_step(model, opt, None)
        w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
        losses = [step(_batch(4, s)) for s in range(3)]
        runs.append((losses, {k: v - w0[k] for k, v in model.net.state_dict().items()}))
    (lf, df), (la, da) = runs
    assert lf[0] == la[0]
    np.testing.assert_allclose(lf, la, rtol=1e-6)
    # torch's foreach Adam and the fused kernel order their float32 arithmetic
    # apart: the updates agree to 1e-4 of a step's size. A key's bias under
    # the softmax has a gradient of rounding alone, which Adam scales to the
    # step size: left out
    for k in da:
        if not k.endswith(".key.bias"):
            assert float((df[k] - da[k]).abs().max()) <= 1e-4 * ADAM["lr"], k


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_run(card, batches, graph, monkeypatch, lr_at=None):
    """(losses, first gradients, state, generator offset, applied updates)
    of make_optimizer's step on the card over ``batches``, replayed or
    eager."""
    model = _model(card)
    opt = make_optimizer(ADAM, model.net, model.trainable_mask())
    with monkeypatch.context() as m:
        if not graph:
            m.setattr(loop, "_on_card", lambda o: False)
        step = make_train_step(model, opt, None, lr_at)
    losses, grads = [], None
    for b in batches:
        losses.append(step(b))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.net.named_parameters()
                     if p.grad is not None}
    return (losses, grads, _state(model, opt), model.generator.get_offset(),
            opt.param_groups[0]["applied_updates"])


def _assert_close_state(a, b, rtol=1e-6):
    (wa, ma), (wb, mb) = a, b
    for k in wa:
        torch.testing.assert_close(wa[k], wb[k], rtol=rtol, atol=0.0, msg=k)
    for sa, sb in zip(ma, mb):
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=rtol, atol=1e-12, msg=k)


@pytest.mark.card
def test_card_replays_match_the_eager_step(card, monkeypatch, counters):
    batches = [_batch(4, s, card) for s in range(3)]
    eager = _card_run(card, batches, False, monkeypatch)
    assert counters() == {}
    replayed = _card_run(card, batches, True, monkeypatch)
    assert counters() == {"train.graph_captures": 1, "train.graph_replays": 3}
    assert replayed[0] == eager[0]
    assert replayed[1].keys() == eager[1].keys()
    for k in eager[1]:
        assert torch.equal(replayed[1][k], eager[1][k]), k
    _assert_close_state(replayed[2], eager[2])
    assert replayed[3] == eager[3] and replayed[4] == eager[4] == 3


@pytest.mark.card
def test_card_nan_batch_skips_the_update(card, monkeypatch, counters):
    nan = torch.full_like(_batch(4, 1, card), float("nan"))
    batches = [_batch(4, 0, card), nan, _batch(4, 2, card)]
    model = _model(card)
    opt = make_optimizer(ADAM, model.net, model.trainable_mask())
    step = make_train_step(model, opt, None)
    assert np.isfinite(step(batches[0]))
    before = _state(model, opt)
    assert math.isnan(step(batches[1]))
    _assert_same(_state(model, opt), before)
    assert opt.param_groups[0]["applied_updates"] == 1
    assert all(float(opt.state[p]["step"]) == 1.0 for p in opt.state)
    assert np.isfinite(step(batches[2]))
    assert opt.param_groups[0]["applied_updates"] == 2
    assert counters()["train.graph_replays"] == 3


@pytest.mark.card
def test_card_generator_moves_as_the_eager_steps(card, monkeypatch):
    batches = [_batch(4, s, card) for s in range(5)]
    eager = _card_run(card, batches, False, monkeypatch)
    replayed = _card_run(card, batches, True, monkeypatch)
    assert replayed[3] == eager[3] > 0


@pytest.mark.card
def test_card_ragged_batch_between_replays(card, monkeypatch, counters):
    batches = [_batch(4, 0, card), _batch(4, 1, card), _batch(3, 2, card), _batch(4, 3, card)]
    eager = _card_run(card, batches, False, monkeypatch)
    replayed = _card_run(card, batches, True, monkeypatch)
    assert counters() == {"train.graph_captures": 1, "train.graph_replays": 3}
    np.testing.assert_allclose(replayed[0], eager[0], rtol=1e-6)
    _assert_close_state(replayed[2], eager[2])
    assert replayed[3] == eager[3]


@pytest.mark.card
def test_card_lr_schedule(card, monkeypatch):
    batches = [_batch(4, s, card) for s in range(4)]
    lr_at = lambda n: 1e-2 * 0.5 ** n
    eager = _card_run(card, batches, False, monkeypatch, lr_at)
    replayed = _card_run(card, batches, True, monkeypatch, lr_at)
    np.testing.assert_allclose(replayed[0], eager[0], rtol=1e-6)
    _assert_close_state(replayed[2], eager[2])


@pytest.mark.card
def test_card_spans_under_the_profiler(card):
    from torch.profiler import ProfilerActivity, profile

    timer = profiling.phase_timer()
    timer.reset()
    model = _model(card)
    step = make_train_step(model, make_optimizer(ADAM, model.net, model.trainable_mask()), None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for s in range(3):
            step(_batch(4, s, card))
    spans = timer.spans()
    timer.reset()
    # the first step's warm-up runs the loss and its backward eagerly twice;
    # its capture records no span, and every step replays
    assert {n: s["calls"] for n, s in spans.items()} == {
        "upgdm.train.step": 3, "upgdm.train.forward": 2, "upgdm.train.backward": 2,
        "upgdm.train.replay": 3, "upgdm.train.sync": 3}
    assert spans["upgdm.train.sync"]["stream_s"] is not None


@pytest.mark.card
def test_card_host_read_in_the_loss_falls_back(card, monkeypatch, counters):
    batches = [_batch(4, s, card) for s in range(3)]
    runs = []
    for graph in (True, False):
        model = _model(card)
        loss_fn = model.loss_fn

        def reads_host(batch, **kw):  # a host read: capture cannot hold it
            out = loss_fn(batch, **kw)
            return out * (1.0 if float(out) > -1.0 else 0.0)

        model.loss_fn = reads_host
        opt = make_optimizer(ADAM, model.net, model.trainable_mask())
        with monkeypatch.context() as m:
            if not graph:
                m.setattr(loop, "_on_card", lambda o: False)
            step = make_train_step(model, opt, None)
        with pytest.warns(UserWarning, match="runs eagerly") if graph else contextlib.nullcontext():
            runs.append(([step(b) for b in batches], model.generator.get_offset()))
    assert counters() == {"train.graph_fallbacks": 1}
    assert runs[0] == runs[1]
    model = _model(card)  # the next capture works
    step = make_train_step(model, make_optimizer(ADAM, model.net, model.trainable_mask()), None)
    assert all(np.isfinite(step(b)) for b in batches)
    assert counters()["train.graph_replays"] == 3


# every family's loss at the card checks' widths through run_training: an epoch
# of two full batches (a capture, two replays) and a ragged one (the eager
# body), against the same run with the step eager. Both runs take the same
# kernels, so their records agree to the last bits
GRAPH_B, GRAPH_V, GRAPH_REL = 8, 6, 1e-5


def _graph_cases():
    """(name, net_param, train_model_select, nodes or None) of each family's
    loss: every NsDiff stage, bf16 through ``cast_loss``, TMDM, DiffSTG and
    NsDiff_spatial with ``adj``, DiffusionTS."""
    from card_checks import DTS_PARAM, SP_PARAM, STG_PARAM, TMDM_TRAIN_PARAM, TRAIN_PARAM

    return (("NsDiff pretrain_f", TRAIN_PARAM, "pretrain_f", None),
            ("NsDiff pretrain_g", TRAIN_PARAM, "pretrain_g", None),
            ("NsDiff_model", TRAIN_PARAM, "NsDiff_model", None),
            ("NsDiff_model bf16", dict(TRAIN_PARAM, train_dtype="bfloat16"), "NsDiff_model",
             None),
            ("TMDM", TMDM_TRAIN_PARAM, None, None),
            ("TMDM bf16", dict(TMDM_TRAIN_PARAM, train_dtype="bfloat16"), None, None),
            ("DiffSTG", STG_PARAM, None, GRAPH_V),
            ("NsDiff_spatial pretrain_f", SP_PARAM, "pretrain_f", GRAPH_V),
            ("NsDiff_spatial pretrain_g", SP_PARAM, "pretrain_g", GRAPH_V),
            ("NsDiff_spatial NsDiff_model", SP_PARAM, "NsDiff_model", GRAPH_V),
            ("DiffusionTS", dict(DTS_PARAM, scaler_type=None), None, None))


@pytest.mark.card
@pytest.mark.parametrize("index", range(11))
def test_card_every_family_replays_as_eager(card, monkeypatch, counters, tmp_path, index):
    cases = _graph_cases()
    name, net, select, nodes = cases[index]
    rng = np.random.default_rng(7)  # each case's data drawn in the cases' order
    for _, n, _, v in cases[:index + 1]:
        shape = (2 * GRAPH_B + 3,) + ((v,) if v else ()) + (n["windows"] + n["pred_len"], 1)
        data = (1.0 + (rng.normal(size=shape) * 0.05).cumsum(axis=-2)).astype(np.float32)
    ring = np.roll(np.eye(GRAPH_V, dtype=np.float32), 1, axis=1)
    train = dict(train_model_select=select, train_batch_size=GRAPH_B, val_batch_size=GRAPH_B,
                 train_epochs=1, test_set=True, ckpt=False)
    opt = dict(optimizer_name="Adam", lr=1e-4, weight_decay=1e-5)
    runs = {}
    for route in ("graph", "eager"):
        profiling.phase_timer().reset()
        with monkeypatch.context() as m:
            if route == "eager":
                m.setattr(loop, "_on_card", lambda o: False)
            rs = run_training(data, data[:GRAPH_B], train, dict(net), {}, opt, tmp_path / route,
                              adj=ring + ring.T if nodes else None, seed=0, device="cuda")
        runs[route] = (rs, {k[len("train.graph_"):]: profiling.counters().get(k, 0)
                            for k in GRAPH_COUNTERS})
    (rs_g, c_g), (rs_e, c_e) = runs["graph"], runs["eager"]
    assert rs_g["epoch"] == rs_e["epoch"] == [0], (
        f"{name}: an epoch did not end (records {rs_g}, {rs_e})")
    got = np.array(rs_g["train_scores"] + rs_g["val_scores"])
    want = np.array(rs_e["train_scores"] + rs_e["val_scores"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    assert np.isfinite(got).all(), f"{name}: records {rs_g}"
    assert (c_g == {"captures": 1, "replays": 2, "fallbacks": 0}
            and c_e == {"captures": 0, "replays": 0, "fallbacks": 0}), (
        f"{name}: graph route {c_g}, eager route {c_e}")
    assert rel <= GRAPH_REL, f"{name}: replayed records {rel} off the eager ones"
