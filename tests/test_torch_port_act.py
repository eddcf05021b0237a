"""bf16 activations (``act_dtype="bfloat16"``) of K1 and K2: the plain twins
against the TPU kernels in Pallas interpret mode, the dtype rules and the
act-bf16 gate table.

Which semantics the interpret-mode kernel computes depends on an XLA flag.
The kernel's source rounds to bf16 after every operation of the gate band,
as Mosaic does on the TPU. XLA's CPU compiler, with its default
``--xla_allow_excess_precision=true``, keeps some of those bf16
intermediates in float32. With the flag false it rounds as the source
states, and the twins then give the kernel's eps bit for bit (measured:
every eps element of F = 1, 2, 4 at 777 rows equal; sigma within 1.2e-7
relative, float32 softplus in another library). One subprocess computes the
references with the flag false; the default-flag kernel is held to the
twins at a bar derived below. On the card ``chip_smoke.py`` holds the CUDA
kernels to these twins.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.ops import diffusion as JD
from upgdm_tpu.ops.pallas.chain_resident import (
    _schedule_table as j_schedule_table,
    fused_chain_rows as j_chain_rows,
)
from upgdm_tpu.ops.pallas.fused_denoiser import fused_denoiser_rows as j_k1
from upgdm_tpu.ops.pallas.fused_denoiser import fused_nsdiff_denoiser as j_denoiser
from upgdm_tpu.ops.schedules import NsDiffSchedule as JSchedule
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.ops.kernels.chain_resident import (
    chain_operands,
    fused_chain_rows,
    fused_chain_rows_reference,
    gate_table,
    schedule_table,
)
from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
    act_bf16,
    check_dtypes,
    fused_denoiser_rows,
    fused_denoiser_rows_reference,
)
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HID = 128
M_ROWS = 777
T = 20
ULP = 2.0 ** -8  # bf16's relative step at the top of a binade
# K1 against the float32-act arm: the JAX package's own bars
# (tests/test_pallas_denoiser.py:63-65); K2: tests/test_chain_resident.py:122-126
JAX_EPS_ABS, JAX_SIGMA_REL, JAX_CHAIN_REL = 1e-2, 1e-2, 0.05


def _weights(F_, rng):
    """(W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs) float32, flax layout, at the
    scale of flax's lecun-normal kernels (1 / sqrt(fan in)); biases 0.1."""
    out = []
    for shape in ((3 * F_, HID), (HID, HID), (HID, HID), (HID, F_), (HID, F_)):
        out.append((rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32))
        out.append((rng.normal(size=shape[1]) * 0.1).astype(np.float32))
    return tuple(out)


def _k1_case(F_):
    rng = np.random.default_rng(F_)
    x = rng.normal(size=(M_ROWS, 3 * F_)).astype(np.float32)
    x[:, 2 * F_:] = np.abs(x[:, 2 * F_:]) + 0.05  # gx > 0
    gammas = tuple(rng.uniform(0, 1, size=HID).astype(np.float32) for _ in range(3))
    return x, gammas, _weights(F_, rng)


def _k2_case(F_=1):
    rng = np.random.default_rng(10 + F_)
    y0 = (rng.normal(size=(M_ROWS, F_)) * 0.5 + 1.0).astype(np.float32)
    gx = rng.uniform(0.05, 1.0, size=(M_ROWS, F_)).astype(np.float32)
    E = tuple(rng.uniform(0, 1, size=(T, HID)).astype(np.float32) for _ in range(3))
    return y0, gx, E, _weights(F_, rng)


def _t(arrays):
    return tuple(map(torch.from_numpy, arrays))


def _j(arrays):
    return tuple(map(jnp.asarray, arrays))


def _head_bar(W):
    """One bf16 step of every unit-norm activation, all aligned, seen by a
    head W [128, F] (Cauchy-Schwarz: sum_c |W_c| 2^-8 |h_c| <= 2^-8 ||W_f||_2
    with ||h||_2 = 1), times two for a step carried over from an earlier
    layer. The default-flag kernel keeps intermediates in float32 that the
    twin rounds, so each activation may sit about one bf16 step away:
    measured 7.5e-4 / 1.9e-4 / 1.4e-3 at F = 1, 2, 4 against bars of
    ~8e-3 (eps; sigma: softplus is 1-Lipschitz, the same bar)."""
    return 2 * ULP * float(np.linalg.norm(W, axis=0).max())


# ------------------------------------------------------------ strict references
_STRICT = r"""
import json, sys
import numpy as np, jax.numpy as jnp
from upgdm_tpu.ops.pallas.fused_denoiser import fused_denoiser_rows
from upgdm_tpu.ops.pallas.chain_resident import fused_chain_rows
spec = json.loads(sys.argv[1])
d = dict(np.load(spec["inputs"]))
out = {}
for F in spec["widths"]:
    x, g, w = d[f"k1_x{F}"], [d[f"k1_g{F}_{i}"] for i in range(3)], [d[f"k1_w{F}_{i}"] for i in range(10)]
    e, s = fused_denoiser_rows(jnp.asarray(x), tuple(map(jnp.asarray, g)), tuple(map(jnp.asarray, w)),
                               interpret=True, matmul_dtype="bfloat16", act_dtype="bfloat16")
    out[f"k1_eps{F}"], out[f"k1_sigma{F}"] = np.asarray(e), np.asarray(s)
E = tuple(jnp.asarray(d[f"k2_E{i}"]) for i in range(3))
w = tuple(jnp.asarray(d[f"k2_w{i}"]) for i in range(10))
for mm in ("float32", "bfloat16"):
    y = fused_chain_rows(jnp.asarray(d["k2_y0"]), jnp.asarray(d["k2_gx"]), jnp.asarray(d["k2_tab"]),
                         0, E, w, spec["T"], interpret=True, matmul_dtype=mm, act_dtype="bfloat16",
                         noise_mode="zero", tile_m=256)
    out[f"k2_{mm}"] = np.asarray(y)
np.savez(spec["outputs"], **out)
"""


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    """The interpret-mode kernels' outputs with --xla_allow_excess_precision
    false, computed in one subprocess on the inputs of ``_k1_case`` and
    ``_k2_case``."""
    tmp = tmp_path_factory.mktemp("strict")
    arrays = {}
    for F_ in (1, 2, 4):
        x, g, w = _k1_case(F_)
        arrays[f"k1_x{F_}"] = x
        arrays.update({f"k1_g{F_}_{i}": a for i, a in enumerate(g)})
        arrays.update({f"k1_w{F_}_{i}": a for i, a in enumerate(w)})
    y0, gx, E, w = _k2_case()
    arrays.update(k2_y0=y0, k2_gx=gx, k2_tab=j_schedule_table(JSchedule.create("linear", T)))
    arrays.update({f"k2_E{i}": a for i, a in enumerate(E)})
    arrays.update({f"k2_w{i}": a for i, a in enumerate(w)})
    np.savez(tmp / "inputs.npz", **arrays)
    spec = dict(inputs=str(tmp / "inputs.npz"), outputs=str(tmp / "outputs.npz"),
                widths=[1, 2, 4], T=T)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_allow_excess_precision=false").strip())
    res = subprocess.run([sys.executable, "-c", _STRICT, json.dumps(spec)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(tmp / "outputs.npz"))


# ---------------------------------------------------------------------------- K1
@pytest.mark.parametrize("F_", [1, 2, 4])
def test_k1_twin_is_the_kernel_source_bit_for_bit(F_, strict):
    """With the flag false: eps equal element by element, sigma within 1e-6
    relative (a float32 softplus and exp of another library in the sigma
    head)."""
    x, g, w = _k1_case(F_)
    eps, sigma = fused_denoiser_rows_reference(torch.from_numpy(x), _t(g), _t(w), "bfloat16",
                                               "bfloat16")
    np.testing.assert_array_equal(eps.numpy(), strict[f"k1_eps{F_}"])
    np.testing.assert_allclose(sigma.numpy(), strict[f"k1_sigma{F_}"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("F_", [1, 2, 4])
def test_k1_twin_against_the_interpret_kernel(F_):
    """The default-flag kernel at ``_head_bar``; the bf16 band moves the
    outputs off the float32-act arm's, by a nonzero amount within the JAX
    package's own bars."""
    x, g, w = _k1_case(F_)
    eps, sigma = fused_denoiser_rows_reference(torch.from_numpy(x), _t(g), _t(w), "bfloat16",
                                               "bfloat16")
    je, js = j_k1(jnp.asarray(x), _j(g), _j(w), interpret=True, matmul_dtype="bfloat16",
                  act_dtype="bfloat16")
    np.testing.assert_allclose(eps.numpy(), np.asarray(je), rtol=0, atol=_head_bar(w[6]))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(js), rtol=0, atol=_head_bar(w[8]))
    e32, s32 = fused_denoiser_rows_reference(torch.from_numpy(x), _t(g), _t(w), "bfloat16",
                                             "float32")
    d_eps = (eps - e32).abs().max().item()
    d_sig = ((sigma - s32).abs() / s32.abs()).max().item()
    assert 0 < d_eps < JAX_EPS_ABS and 0 < d_sig < JAX_SIGMA_REL, (d_eps, d_sig)


def test_k1_wrapper_on_cpu_is_the_twin():
    x, g, w = _k1_case(2)
    got = fused_denoiser_rows(torch.from_numpy(x), _t(g), _t(w), matmul_dtype="bfloat16",
                              act_dtype="bfloat16")
    want = fused_denoiser_rows_reference(torch.from_numpy(x), _t(g), _t(w), "bfloat16",
                                         "bfloat16")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_denoiser_rows.launches == 0


# ---------------------------------------------------------------------------- K2
def _port_chain(mm, act="bfloat16", **kw):
    y0, gx, E, w = _k2_case()
    tab = torch.from_numpy(schedule_table(NsDiffSchedule.create("linear", T)))
    return fused_chain_rows_reference(torch.from_numpy(y0), torch.from_numpy(gx), tab, _t(E),
                                      _t(w), T, matmul_dtype=mm, act_dtype=act,
                                      noise_mode="zero", **kw)


def _chain_weight(gx_max=1.0):
    """sum over t of |d y_0 / d eps_t| of the noise-free chain (the weight
    ``chip_smoke.py::chain_error_weight`` derives; 0.86 at 20 steps)."""
    s = JSchedule.create("linear", T)
    a, bt_m1, bb_m1, acp_prev, bb = (np.asarray(v, np.float64) for v in (
        s.alphas, s.betas_tilde_m_1, s.betas_bar_m_1, s.alphas_cumprod_prev, s.betas_bar))
    sqrt_abar = np.sqrt(1.0 - np.asarray(s.one_minus_alphas_bar_sqrt, np.float64) ** 2)
    s1 = (1.0 - a) ** 2 * gx_max + a * (1.0 - a) * gx_max
    s2 = (bb_m1 - bt_m1) * gx_max + bt_m1 * gx_max
    g0, g1 = np.sqrt(acp_prev) * s1 / (a * s2 + s1), np.sqrt(a) * s2 / (a * s2 + s1)
    by_eps = np.sqrt(bb * gx_max) / sqrt_abar
    by_eps[1:] *= g0[1:]
    onward = g0 / sqrt_abar + g1
    return float(sum(by_eps[t] * np.prod(onward[1:t]) for t in range(T)))


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_k2_twin_is_the_kernel_source(mm, strict):
    """Noise-free, 20 steps, flag false: the trunk rounds as the twin, the
    posterior arithmetic is float32 in another library (XLA may contract
    to FMAs), and a bf16 rounding that falls the other way once moves y by
    a step's K1 bar times the chain's weight: at least 99% of the rows
    equal to 1e-6, all within that bar."""
    got = _port_chain(mm).numpy()
    want = strict[f"k2_{mm}"]
    close = np.abs(got - want) <= 1e-6 * (1.0 + np.abs(want))
    assert close.mean() >= 0.99, close.mean()
    _, _, _, w = _k2_case()
    np.testing.assert_allclose(got, want, rtol=0, atol=_head_bar(w[6]) * _chain_weight())


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_k2_twin_against_the_interpret_kernel(mm):
    """``fused_nsdiff_chain`` in interpret mode, zero noise, default flag:
    each step's eps within K1's bar, carried by the chain's weight; against
    the float32-act chain a nonzero difference within the JAX package's bar
    (mean |d| / mean |y| < 0.05)."""
    y0, gx, E, w = _k2_case()
    got = _port_chain(mm).numpy()
    want = np.asarray(j_chain_rows(
        jnp.asarray(y0), jnp.asarray(gx), j_schedule_table(JSchedule.create("linear", T)), 0,
        _j(E), _j(w), T, interpret=True, matmul_dtype=mm, act_dtype="bfloat16",
        noise_mode="zero", tile_m=256))
    np.testing.assert_allclose(got, want, rtol=0, atol=_head_bar(w[6]) * _chain_weight())
    f32 = _port_chain(mm, act="float32").numpy()
    rel = np.abs(got - f32).mean() / np.abs(f32).mean()
    assert 0 < rel < JAX_CHAIN_REL, rel


def test_k2_wrapper_on_cpu_takes_every_combination():
    y0, gx, E, w = _k2_case()
    tab = schedule_table(NsDiffSchedule.create("linear", T))
    outs = {}
    for mm in ("float32", "bfloat16"):
        for act in ("float32", "bfloat16"):
            outs[mm, act] = fused_chain_rows(torch.from_numpy(y0), torch.from_numpy(gx), tab, 3,
                                             _t(E), _t(w), T, matmul_dtype=mm, act_dtype=act,
                                             noise_mode="zero")
            assert torch.equal(outs[mm, act], _port_chain(mm, act))
    assert len({o.numpy().tobytes() for o in outs.values()}) == 4
    assert fused_chain_rows.launches == 0


# ------------------------------------------------- the model's chain through K1
def test_sample_chain_through_k1_matches_the_pallas_chain():
    """``NsDiffModel.sample_chain(use_kernel=True)`` with
    ``sampling_act_dtype="bfloat16"``: 20 noise-free steps of the K1 twin
    against JAX's ``nsdiff_p_sample_loop`` driving the interpret-mode kernel
    (its normals set to zero), at K1's bar carried by the chain's weight;
    the same chain with float32 activations differs."""
    net = dict(dataset_nf=1, windows=16, pred_len=8, rolling_length=4, diffusion_steps=T,
               scaler_type=None, d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
               p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=2, task_model="NsDiff",
               sampling_matmul_dtype="bfloat16", sampling_act_dtype="bfloat16")
    port = NsDiffModel(net, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    y0 = (rng.normal(size=(3, 8, 1)) * 0.5 + 1.0).astype(np.float32)
    gx = rng.uniform(0.05, 1.0, size=(3, 8, 1)).astype(np.float32)
    zeros = [np.zeros((2, 3, 8, 1), np.float32)] * T
    got = port.sample_chain(torch.from_numpy(y0), torch.from_numpy(gx), n_z_samples=2,
                            noise=zeros, use_kernel=True)[..., 0].numpy()

    d = port.denoiser
    flat = {k[len("model."):]: v for k, v in port.state_dict().items() if k.startswith("model.")}
    from upgdm_tpu.utils.io import unflatten_params

    params = jax.tree.map(jnp.asarray, unflatten_params(flat))

    def model_fn(y, t):
        return j_denoiser(params, y, jnp.asarray(y0), jnp.asarray(gx), t, interpret=True,
                          matmul_dtype="bfloat16", act_dtype="bfloat16")

    def zero_normal(key, shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    with mock.patch.object(JD.jax.random, "normal", zero_normal):
        want = np.asarray(JD.nsdiff_p_sample_loop(model_fn, jnp.asarray(y0), jnp.asarray(gx),
                                                  JSchedule.create("linear", T),
                                                  jax.random.key(0)))
    W4 = d.lin4.weight.detach().t().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_head_bar(W4) * _chain_weight())
    port.net_param["sampling_act_dtype"] = "float32"
    f32 = port.sample_chain(torch.from_numpy(y0), torch.from_numpy(gx), n_z_samples=2,
                            noise=zeros, use_kernel=True)[..., 0].numpy()
    assert np.abs(got - f32).max() > 0


# -------------------------------------------------------------- dtype rules, table
def test_dtype_rules_of_the_two_kernels():
    """K1 refuses float32 matmuls with bf16 activations (ValueError, as
    ``fused_denoiser.py:170-172``); K2 takes all four; a typo raises."""
    assert check_dtypes("bfloat16", "bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="requires matmul_dtype=bfloat16"):
        check_dtypes("float32", "bfloat16")
    x, g, w = _k1_case(1)
    with pytest.raises(ValueError):
        fused_denoiser_rows_reference(torch.from_numpy(x), _t(g), _t(w), "float32", "bfloat16")
    for mm in ("float32", "bfloat16"):
        for act in ("float32", "bf16", "bfloat16"):
            assert check_dtypes(mm, act, chain=True) == getattr(torch, mm)
    with pytest.raises(ValueError, match="act_dtype"):
        act_bf16("fp16")
    with pytest.raises(ValueError, match="matmul_dtype"):
        check_dtypes("fp8", "float32", chain=True)


def test_act_gate_table_holds_bf16_gate_and_bias():
    """For bf16 activations entry (t, layer, p) is gate_pair_act of
    csrc/trunk_mma.cuh: (g[2p], g[2p+1], b[2p], b[2p+1]) rounded to bf16
    once; chain_operands makes it and the wrapper takes it for that arm."""
    rng = np.random.default_rng(7)
    E = _t(tuple(rng.uniform(0, 1, size=(3, HID)).astype(np.float32) for _ in range(3)))
    b = _t(tuple(rng.normal(size=HID).astype(np.float32) for _ in range(3)))
    tab = gate_table(E, *b, act_dtype="bfloat16")
    assert tab.shape == (3, 3, 64, 4) and tab.dtype == torch.bfloat16 and tab.is_contiguous()
    for layer in range(3):
        assert torch.equal(tab[:, layer, :, :2].reshape(3, HID), E[layer].to(torch.bfloat16))
        want_b = b[layer].to(torch.bfloat16).expand(3, HID)
        assert torch.equal(tab[:, layer, :, 2:].reshape(3, HID), want_b)
    w = _t(_weights(1, rng))
    gates, _ = chain_operands(E, w, torch.bfloat16, "bfloat16")
    assert torch.equal(gates, gate_table(E, w[1], w[3], w[5], "bfloat16"))
