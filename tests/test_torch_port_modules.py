"""Port modules (upgdm_tpu_torch) held against the JAX package on the CPU.

Inputs are made with numpy from a seed; flax weights are carried into the
port by ``torch_state_from_flax`` and loaded strictly. Tolerances are the
JAX package's own bars (ROADMAP North star) unless stated otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.models.denoise import NsDiffDenoiser as JDenoiser
from upgdm_tpu.models.ns_transformer import NSTransformer as JNSTransformer
from upgdm_tpu.models.sigma_estimation import SigmaEstimation as JSigma
from upgdm_tpu.ops import diffusion as JD
from upgdm_tpu.ops.rolling import wv_sigma_trailing as j_wv_sigma_trailing
from upgdm_tpu.ops.schedules import NsDiffSchedule as JSchedule
from upgdm_tpu.utils.io import flatten_params
from upgdm_tpu_torch.models import base as port_base
from upgdm_tpu_torch.models.denoise import NsDiffDenoiser
from upgdm_tpu_torch.models.ns_transformer import NSTransformer, _act, _series_stats
from upgdm_tpu_torch.models.sigma_estimation import SigmaEstimation
from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops.rolling import wv_sigma_trailing
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch, torch_state_from_flax


def _load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(torch_state_from_flax(flatten_params(jax.device_get(params))),
                           strict=True)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("kind", ["linear", "quad", "sigmoid", "cosine"])
def test_schedule_arrays_bit_equal(kind):
    want = JSchedule.create(kind, 20, 1e-4, 2e-2)
    got = NsDiffSchedule.create(kind, 20, 1e-4, 2e-2)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype == np.float32, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("discard_rep", [False, True])
def test_wv_sigma_trailing(discard_rep):
    x = np.random.default_rng(0).normal(size=(3, 60, 2)).astype(np.float32) * 0.3 + 1.0
    want = np.asarray(j_wv_sigma_trailing(jnp.asarray(x), 24, discard_rep=discard_rep))
    got = wv_sigma_trailing(_t(x), 24, discard_rep=discard_rep).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_sigma_estimation():
    W, P, N, H, K = 40, 12, 2, 64, 10
    x = (np.random.default_rng(1).normal(size=(4, W, N)) * 0.2 + 1.0).astype(np.float32)
    jm = JSigma(W, P, N, H, K)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    port = _load_flax(SigmaEstimation(W, P, N, H, K), params)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layers", [(1, 1), (2, 2)])
def test_ns_transformer(layers):
    """f(x) at d_model 32 (tanh GELU, LayerNorm eps 1e-6, population std).
    Bar: atol 1e-4 — float32 sums in another order through ~10 layers."""
    e_layers, d_layers = layers
    W, P, N = 24, 8, 1
    kw = dict(seq_len=W, label_len=W // 2, pred_len=P, enc_in=N, d_model=32, n_heads=2,
              e_layers=e_layers, d_layers=d_layers, d_ff=64, p_hidden_dims=(16, 16),
              p_hidden_layers=2)
    x = (np.random.default_rng(2).normal(size=(3, W, N)) * 0.5 + 2.0).astype(np.float32)
    jm = JNSTransformer(**kw, dropout=0.0, activation="gelu")
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))["params"]
    want, want_dec = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    port = _load_flax(NSTransformer(**kw, activation="gelu"), params)
    with torch.no_grad():
        got, got_dec = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("F_,batched_t", [(1, False), (2, True)])
def test_nsdiff_denoiser(F_, batched_t):
    steps, B, O = 7, 5, 9
    rng = np.random.default_rng(3)
    y_t = rng.normal(size=(B, O, F_)).astype(np.float32)
    y0 = rng.normal(size=(B, O, F_)).astype(np.float32)
    gx = rng.uniform(0.1, 1.0, size=(B, O, F_)).astype(np.float32)
    t_np = rng.integers(0, steps, size=B) if batched_t else np.full(B, 3)
    jm = JDenoiser(enc_in=F_, n_steps=steps)
    params = jax.jit(jm.init)(jax.random.key(2), y_t, y0, gx, jnp.asarray(t_np))["params"]
    eps_w, sig_w = jm.apply({"params": params}, y_t, y0, gx, jnp.asarray(t_np))
    port = _load_flax(NsDiffDenoiser(F_, steps), params)
    t = torch.as_tensor(t_np) if batched_t else 3
    with torch.no_grad():
        eps, sig = port(_t(y_t), _t(y0), _t(gx), t)
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_w), atol=3e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_w), atol=3e-5)


@pytest.mark.parametrize("t", [1, 10, 19])
def test_reverse_step_coefficients(t):
    """gammas and the sigma_y0 quadratic at rtol 2e-4 (2e-3 for gamma_2,
    a difference of nearly equal terms)."""
    sched_j = JSchedule.create("linear", 20, 1e-4, 2e-2)
    sched = NsDiffSchedule.create("linear", 20, 1e-4, 2e-2)
    rng = np.random.default_rng(4)
    gx = rng.uniform(0.05, 1.0, size=(6, 10, 1)).astype(np.float32)
    sig = rng.uniform(0.01, 0.5, size=(6, 10, 1)).astype(np.float32)
    cj = JD.nsdiff_gather(sched_j, jnp.asarray(t), jnp.asarray(gx))
    c = D.nsdiff_gather(sched, t, _t(gx))
    sy_w = np.asarray(JD._nsdiff_sigma_y0_hat(cj, jnp.asarray(gx), jnp.asarray(sig)))
    sy = D._nsdiff_sigma_y0_hat(c, _t(gx), _t(sig)).numpy()
    np.testing.assert_allclose(sy, sy_w, rtol=2e-4)
    want = JD.nsdiff_gammas(cj, jnp.asarray(gx), jnp.asarray(sy_w))
    got = D.nsdiff_gammas(c, _t(gx), _t(sy_w))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3 if i == 2 else 2e-4)


def test_weight_bridge_round_trip_and_strict_keys():
    jm = JDenoiser(enc_in=1, n_steps=5)
    y = jnp.zeros((2, 3, 1))
    flat = flatten_params(jax.device_get(
        jax.jit(jm.init)(jax.random.key(0), y, y, y, jnp.zeros(2, jnp.int32))["params"]))
    back = flax_flat_from_torch(torch_state_from_flax(flat))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError):
        torch_state_from_flax({"lin1.Dense_0.mystery": np.zeros(3)})
    port = NsDiffDenoiser(1, 5)
    sd = torch_state_from_flax(flat)
    sd.pop("lin4.bias")
    with pytest.raises(RuntimeError):
        port.load_state_dict(sd, strict=True)


def test_numeric_traps():
    """Each trap read off the JAX package, checked directly."""
    # the port's "gelu" is flax nn.gelu, the tanh approximation
    x = torch.linspace(-6, 6, 1001)
    np.testing.assert_allclose(_act("gelu")(x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), atol=1e-6)
    # every LayerNorm uses flax's epsilon
    m = NSTransformer(24, 12, 8, 1, d_model=16, n_heads=2, e_layers=2, d_layers=1, d_ff=8)
    lns = [mod for mod in m.modules() if isinstance(mod, torch.nn.LayerNorm)]
    lns += [mod for mod in SigmaEstimation(40, 8, 1, 16, 10).modules()
            if isinstance(mod, torch.nn.LayerNorm)]
    assert lns and all(mod.eps == 1e-6 for mod in lns)
    # population std with 1e-5 inside the sqrt
    s = np.random.default_rng(5).normal(size=(2, 30, 1)).astype(np.float32)
    _, std = _series_stats(_t(s))
    np.testing.assert_allclose(std.numpy()[:, 0, 0], np.sqrt(s.var(axis=1)[:, 0] + 1e-5),
                               rtol=1e-6)
    # EPS = 10e-8 is 1e-7
    assert D.EPS == port_base.EPS == 1e-7
