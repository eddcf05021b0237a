"""The de-stationary attention as one function (``ops/kernels/ds_attention.py``):
its plain twin against the arithmetic ``DSAttention.forward`` held before the
kernel, and the gate that sends a call to the kernel, to the twin or to an
error.

The twin is the CPU path, so it must give the old forward's bits at the
NsDiff and TMDM sweeps' calls. The gate's route on the card is checked here
with the card stood in for (``_on_card``) and the launch replaced by a
recorder; the CUDA kernel itself is held to the twin on the card by
``test_torch_port_card_kernels.py`` (``attention_checks``).
"""
import math
import re
from pathlib import Path

import pytest
import torch

from upgdm_tpu_torch.models.attention import AttentionLayer, DSAttention
from upgdm_tpu_torch.ops.kernels import _build, roofline
from upgdm_tpu_torch.ops.kernels import ds_attention as K
from upgdm_tpu_torch.utils.profiling import counters
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parents[1] / "upgdm_tpu_torch" / "csrc"

# (H, E) of the NsDiff sweep's f(x) (d_model 512) and of TMDM's (d_model 64);
# the sweeps' calls (L, S, causal); a few series each
FAMILIES = {"nsdiff": (8, 64), "tmdm": (4, 16)}
CALLS = {"encoder": (100, 100, False), "decoder_self": (150, 150, True),
         "cross": (150, 100, False)}
B = 3


def old_forward(queries, keys, values, mask_flag, dropout, tau=None, delta=None, gen=None):
    """``DSAttention.forward`` as it stood before the kernel."""
    B_, L, H, E = queries.shape
    scale = 1.0 / math.sqrt(E)
    scores = torch.einsum("blhe,bshe->bhls", queries, keys)
    if tau is not None:
        scores = scores * tau[:, :, None, None]
    if delta is not None:
        scores = scores + delta[:, None, None, :]
    if mask_flag:
        S = scores.shape[-1]
        causal = torch.ones(L, S, dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~causal, -1e9)
    attn = dropout(torch.softmax(scale * scores, dim=-1), gen)
    return torch.einsum("bhls,bshd->blhd", attn, values)


def operands(H, E, L, S, seed=0, dtype=torch.float32):
    """q, k, v as views of [B, *, H E] (AttentionLayer's layout), tau, delta."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, L, H * E, generator=g).view(B, L, H, E)
    k = torch.randn(B, S, H * E, generator=g).view(B, S, H, E)
    v = torch.randn(B, S, H * E, generator=g).view(B, S, H, E)
    tau = torch.rand(B, 1, generator=g) + 0.5
    delta = torch.randn(B, S, generator=g)
    return [t.to(dtype) for t in (q, k, v, tau, delta)]


@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "no_delta"])
@pytest.mark.parametrize("with_tau", [True, False], ids=["tau", "no_tau"])
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_twin_is_the_old_forward_bit_for_bit(family, call, with_tau, with_delta):
    H, E = FAMILIES[family]
    L, S, causal = CALLS[call]
    q, k, v, tau, delta = operands(H, E, L, S)
    tau, delta = tau if with_tau else None, delta if with_delta else None
    mod = DSAttention(causal, 0.05)
    want = old_forward(q, k, v, causal, mod.dropout, tau, delta)
    assert torch.equal(mod(q, k, v, tau, delta), want)
    assert torch.equal(K.ds_attention_reference(q, k, v, tau, delta, causal), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_twin_draws_the_old_dropout(causal):
    q, k, v, tau, delta = operands(8, 64, 150, 150, seed=1)
    mod = DSAttention(causal, 0.05)
    got = mod(q, k, v, tau, delta, gen=torch.Generator().manual_seed(5))
    want = old_forward(q, k, v, causal, mod.dropout, tau, delta, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


def test_attention_layer_output_unchanged():
    """AttentionLayer on the twin: the old forward's output through the same
    projections."""
    torch.manual_seed(0)
    layer = AttentionLayer(64, 4, mask_flag=True)
    x = torch.randn(2, 30, 64)
    tau = torch.rand(2, 1) + 0.5
    got = layer(x, x, x, tau=tau)
    q, k, v = (getattr(layer, n)(x).reshape(2, 30, 4, 16) for n in ("query", "key", "value"))
    want = layer.out(old_forward(q, k, v, True, layer.inner.dropout, tau).reshape(2, 30, 64))
    assert torch.equal(got, want)


# -- the gate -------------------------------------------------------------------------

STAND_IN_MAX_KEYS = 7168  # the kernel's limit at E 64 on an H100 (227 KB of shared memory)


@pytest.fixture
def card_stand_in(monkeypatch):
    """Every tensor counts as on the card; a launch records its call and
    returns the twin's answer, contiguous as the kernel's."""
    launched = []

    def launch(q, k, v, tau, delta, causal):
        launched.append(dict(shape=tuple(q.shape), S=k.shape[1], causal=causal,
                             aligned=all(K._rows_fit(t) for t in (q, k, v))
                             and (delta is None or delta.stride(1) == 1)))
        return K.ds_attention_reference(q, k, v, tau, delta, causal).contiguous()

    monkeypatch.setattr(K, "_on_card", lambda t: True)
    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "max_keys", lambda E: STAND_IN_MAX_KEYS)
    return launched


def tally():
    c = counters()
    return c.get("ds_attention.launches", 0), c.get("ds_attention.fallbacks", 0)


def plain_calls():
    """Calls of DSAttention the twin runs by design: the train step's
    gradient, its dropout, bf16 backbones."""
    q, k, v, tau, delta = operands(8, 64, 100, 100)
    grad = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bf16 = operands(8, 64, 100, 100, dtype=torch.bfloat16)
    return {
        "gradient": dict(q=grad[0], k=grad[1], v=grad[2], tau=tau, delta=delta),
        "dropout": dict(q=q, k=k, v=v, tau=tau, delta=delta, gen=torch.Generator()),
        "dtype": dict(q=bf16[0], k=bf16[1], v=bf16[2], tau=bf16[3], delta=bf16[4]),
    }


def as_call(ops):
    return dict(zip(("q", "k", "v", "tau", "delta"), ops))


def kernel_calls():
    """Sampling calls the kernel takes beyond the sweeps': the paper models'
    head width 8 (d_model 16, 2 heads) at W/P 200/200, E 32, the SLBP grid's
    decoder at E 64 (300 keys), a query layout 4 bytes off 16 and a strided
    delta (both copied before the launch)."""
    q, k, v, tau, delta = operands(8, 64, 100, 100)
    flat = torch.randn(B * 100 * 512 + 1)[1:].view(B, 100, 8, 64)
    wide = torch.randn(B, 200)[:, ::2]
    return {
        "head width 8": as_call(operands(2, 8, 300, 200)),
        "head width 32": as_call(operands(16, 32, 100, 100)),
        "keys": as_call(operands(8, 64, 300, 300)),
        "layout": dict(q=flat, k=k, v=v, tau=tau, delta=delta),
        "delta stride": dict(q=q, k=k, v=v, tau=tau, delta=wide),
    }


def refused_calls():
    """Float32 sampling calls the kernel cannot take, by the words of the
    error: an unbuilt head width, more keys than it holds, shapes or devices
    that disagree."""
    q, k, v, tau, delta = operands(8, 64, 100, 100)
    return {
        "head width 12": (as_call(operands(4, 12, 100, 100)), "head width 12"),
        "keys": (as_call(operands(8, 64, 10, STAND_IN_MAX_KEYS + 1)), "more than the 7168"),
        "shape": (dict(q=q, k=k, v=v[:, :99], tau=tau, delta=delta), "shapes disagree"),
        "device": (dict(q=q, k=k, v=v, tau=tau.to("meta"), delta=delta), "one device"),
    }


PLAIN = ("gradient", "dropout", "dtype")
KERNEL = ("head width 8", "head width 32", "keys", "layout", "delta stride")
REFUSED = ("head width 12", "keys", "shape", "device")


def run(call, causal=False, use_kernel=True):
    mod = DSAttention(causal, 0.05)
    mod.use_kernel = use_kernel
    return mod(call["q"], call["k"], call["v"], call["tau"], call["delta"], gen=call.get("gen"))


@pytest.mark.parametrize("why", PLAIN)
def test_gate_takes_the_twin_on_the_card_and_counts_it(card_stand_in, why):
    call = plain_calls()[why]
    unfit = K.kernel_unfit(call["q"], call["k"], call["v"], call["tau"], call["delta"],
                           call.get("gen") is not None)
    assert unfit == why
    before = tally()
    out = run(call)
    assert card_stand_in == []
    assert tuple(a - b for a, b in zip(tally(), before)) == (0, 1)
    want = old_forward(call["q"], call["k"], call["v"], False, DSAttention().dropout,
                       call["tau"], call["delta"])
    if why != "dropout":
        assert torch.equal(out, want)


@pytest.mark.parametrize("why", PLAIN + KERNEL)
def test_gate_takes_the_twin_on_the_cpu_uncounted(why):
    call = {**plain_calls(), **kernel_calls()}[why]
    before = tally()
    run(call)
    assert tally() == before


@pytest.mark.parametrize("why", ["head width 12", "keys"])
def test_gate_runs_the_twin_on_the_cpu_where_the_card_refuses(why):
    call, _ = refused_calls()[why]
    before = tally()
    out = run(call)
    assert tally() == before
    assert torch.equal(out, old_forward(call["q"], call["k"], call["v"], False,
                                        DSAttention().dropout, call["tau"], call["delta"]))


@pytest.mark.parametrize("why", KERNEL)
def test_gate_launches_every_other_float32_sampling_call(card_stand_in, why):
    call = kernel_calls()[why]
    assert K.kernel_unfit(call["q"], call["k"], call["v"], call["tau"], call["delta"]) is None
    before = tally()
    with torch.no_grad():
        out = run(call)
    assert len(card_stand_in) == 1 and card_stand_in[0]["aligned"]
    assert card_stand_in[0]["S"] == call["k"].shape[1]
    assert tuple(a - b for a, b in zip(tally(), before)) == (1, 0)
    want = old_forward(call["q"], call["k"], call["v"], False, DSAttention().dropout,
                       call["tau"], call["delta"])
    assert torch.equal(out, want)


@pytest.mark.parametrize("why", REFUSED)
def test_gate_raises_for_a_call_the_kernel_cannot_take(card_stand_in, why):
    call, words = refused_calls()[why]
    before = tally()
    with torch.no_grad(), pytest.raises(ValueError, match=words):
        run(call)
    assert card_stand_in == [] and tally() == before


@pytest.mark.parametrize("empty", ["keys", "series"])
def test_gate_gives_the_twins_zeros_for_an_empty_call(card_stand_in, empty):
    q, k, v, tau, delta = operands(8, 64, 10, 0 if empty == "keys" else 10)
    if empty == "series":
        q, k, v, tau, delta = (t[:0] for t in (q, k, v, tau, delta))
    with torch.no_grad():
        out = K.ds_attention(q, k, v, tau, delta)
    assert card_stand_in == []
    assert torch.equal(out, old_forward(q, k, v, False, DSAttention().dropout, tau, delta))


def test_gate_launches_a_sampling_call(card_stand_in):
    q, k, v, tau, delta = operands(8, 64, 150, 150)
    before = tally()
    with torch.inference_mode():
        out = run(dict(q=q, k=k, v=v, tau=tau, delta=None), causal=True)
    assert card_stand_in == [dict(shape=(B, 150, 8, 64), S=150, causal=True, aligned=True)]
    assert tuple(a - b for a, b in zip(tally(), before)) == (1, 0)
    assert out.is_contiguous()


def test_gate_launches_without_a_gradient_wanted(card_stand_in):
    """Grad mode on but no input that requires grad (the weights frozen)."""
    q, k, v, tau, delta = operands(4, 16, 100, 100)
    assert torch.is_grad_enabled()
    run(dict(q=q, k=k, v=v, tau=tau, delta=delta))
    with torch.no_grad():
        grad = [t.clone().requires_grad_(True) for t in (q, k, v)]
        run(dict(q=grad[0], k=grad[1], v=grad[2], tau=None, delta=None))
    assert len(card_stand_in) == 2


def test_gate_forced_twin(card_stand_in):
    q, k, v, tau, delta = operands(8, 64, 100, 100)
    call = dict(q=q, k=k, v=v, tau=tau, delta=delta)
    before = tally()
    run(call, use_kernel=False)
    assert card_stand_in == []
    assert tuple(a - b for a, b in zip(tally(), before)) == (0, 1)


def test_model_attention_starts_on_the_gate():
    layer = AttentionLayer(512, 8)
    assert layer.inner.use_kernel is True
    assert "use_kernel" not in layer.state_dict()


# -- what the wrapper and the source agree on -------------------------------------------


def test_wrapper_limits_match_the_source():
    src = (CSRC / "ds_attention.cu").read_text()
    built = sorted(int(e) for e in re.findall(r"if \(E == (\d+)\) return launch<\1>", src))
    assert built == sorted(K.BUILT_E)
    declared = Path(_build.__file__).read_text()
    assert "upgdm_ds_attention.argtypes" in declared
    assert "upgdm_ds_attention_max_keys.argtypes" in declared
    assert "--use_fast_math" not in _build.FLAGS


@pytest.mark.parametrize("call,ms,by", [("encoder", 0.147, "operations"),
                                        ("decoder_self", 0.176, "bytes"),
                                        ("cross", 0.220, "operations")])
def test_bound_at_the_nsdiff_sweeps_calls(call, ms, by):
    """At 480 series x 8 heads x E 64 float32 operations bind, but for the
    causal call, which counts the pairs up to the query only (151 / 300 of
    the square, 0.166 ms of operations): its q, k, v and out take 0.176 ms."""
    L, S, causal = CALLS[call]
    work = roofline.ds_attention_work(480, 8, L, S, 64, causal, True, not causal)
    got, bound_by = roofline.bound_ms(*work, "float32", 1980e6)
    assert bound_by == by and got == pytest.approx(ms, abs=1e-3)
    full = roofline.ds_attention_work(480, 8, L, S, 64, False)[0]
    assert work[0] == (full * (L + 1) / (2 * L) if causal else full)
