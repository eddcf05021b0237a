"""The port's TMDM sampling slice held against the JAX package (CPU).

Weights are drawn by the JAX package and carried into the port through
``utils/weights.py``; inputs are made with numpy from a seed. On the CPU the
K3 wrapper runs its plain twin; the JAX kernel runs in Pallas interpret
mode. The CUDA kernel itself is held against the same twin on the card by
``test_torch_port_card_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.models.denoise import TMDMDenoiser as JDenoiser
from upgdm_tpu.models.ns_transformer import NSTransformerVAE as JVAE
from upgdm_tpu.models.tmdm import TMDMModel as JTMDM
from upgdm_tpu.ops import diffusion as JD
from upgdm_tpu.ops.pallas.fused_denoiser import fused_tmdm_denoiser as j_fused_tmdm
from upgdm_tpu.ops.schedules import card_schedule as j_card_schedule
from upgdm_tpu.utils.io import flatten_params
from upgdm_tpu_torch import diffusion_models
from upgdm_tpu_torch.models.denoise import TMDMDenoiser
from upgdm_tpu_torch.models.ns_transformer import NSTransformerVAE
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops.kernels.fused_tmdm import (
    fused_tmdm_denoiser,
    fused_tmdm_rows,
    fused_tmdm_rows_reference,
    tmdm_gammas,
    tmdm_weights,
)
from upgdm_tpu_torch.ops.schedules import card_schedule
from upgdm_tpu_torch.utils.weights import torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 6
TINY = dict(
    dataset_nf=1, windows=24, pred_len=12, diffusion_steps=STEPS, scaler_type=None,
    d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=32, p_hidden_dims=[8, 8],
    p_hidden_layers=2, n_z_samples=4, task_model="TMDM", sampling_dtype="float32",
)


def _load_flax(module, params):
    module.load_state_dict(torch_state_from_flax(flatten_params(jax.device_get(params))),
                           strict=True)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _windows(B, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, TINY["windows"], 1)) * 0.1 + 1.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_card_schedule_bit_equal(kind):
    want, got = j_card_schedule(kind, 20, 1e-4, 2e-2), card_schedule(kind, 20, 1e-4, 2e-2)
    assert got.num_timesteps == want.num_timesteps == 20
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype == np.float32, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    on = D.schedule_on(got, "cpu")
    assert torch.equal(on.alphas, torch.from_numpy(want.alphas))


def test_card_q_sample_matches_jax():
    rng = np.random.default_rng(0)
    y, y0, z = (rng.normal(size=(5, 7, 2)).astype(np.float32) for _ in range(3))
    t = rng.integers(0, 20, size=5)
    want = JD.card_q_sample(jnp.asarray(y), jnp.asarray(y0), j_card_schedule("linear", 20),
                            jnp.asarray(t), jnp.asarray(z))
    got = D.card_q_sample(_t(y), _t(y0), card_schedule("linear", 20), t, _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _denoiser_pair(F_, cat_x, cat_y_pred, L=9, d=5, seed=0):
    """A flax TMDMDenoiser's params and the port module carrying them."""
    jm = JDenoiser(enc_in=F_, n_steps=STEPS + 1, cat_x=cat_x, cat_y_pred=cat_y_pred)
    y, emb = jnp.zeros((2, L, F_)), jnp.zeros((2, L, d))
    params = jax.jit(jm.init)(jax.random.key(seed), emb, y, y, jnp.zeros(2, jnp.int32))["params"]
    port = TMDMDenoiser(F_, STEPS + 1, cat_x=cat_x, cat_y_pred=cat_y_pred, x_dim=d)
    return jm, params, _load_flax(port, params)


@pytest.mark.parametrize("cat_x,cat_y_pred,batched_t",
                         [(True, True, False), (True, False, True), (False, False, False)])
def test_tmdm_denoiser_layouts(cat_x, cat_y_pred, batched_t):
    """All three input layouts against the flax module, atol 2e-5."""
    B, L, F_, d = 4, 9, 2, 5
    jm, params, port = _denoiser_pair(F_, cat_x, cat_y_pred, L, d)
    rng = np.random.default_rng(1)
    y_t, y0 = (rng.normal(size=(B, L, F_)).astype(np.float32) for _ in "ab")
    emb = rng.normal(size=(B, L, d)).astype(np.float32)
    t_np = rng.integers(0, STEPS + 1, size=B) if batched_t else np.full(B, STEPS)
    want = jm.apply({"params": params}, emb, y_t, y0, jnp.asarray(t_np))
    t = torch.as_tensor(t_np) if batched_t else STEPS
    with torch.no_grad():
        got = port(_t(emb), _t(y_t), _t(y0), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# bf16 bar: both sides round the same operands to bf16 and sum exact products
# in float32, but in another order; an activation within an ulp of a bf16
# rounding boundary can round the other way (a 2^-8 relative step in one of
# 128 terms), so the bf16 arm is held to 2e-3 instead of 2e-5.
@pytest.mark.parametrize("F_", [1, 2])
@pytest.mark.parametrize("mm,atol", [("float32", 2e-5), ("bfloat16", 2e-3)])
@pytest.mark.parametrize("t", [0, STEPS])
def test_k3_twin_matches_pallas_kernel(F_, mm, atol, t):
    """5 x 9 = 45 rows: ragged against the 32-row tile the JAX side is given
    and against the CUDA kernel's 32-row groups."""
    _, params, port = _denoiser_pair(F_, True, True, seed=F_)
    rng = np.random.default_rng(10 * F_ + t)
    y_t, y0 = (rng.normal(size=(5, 9, F_)).astype(np.float32) for _ in "ab")
    want = np.asarray(j_fused_tmdm(params, jnp.asarray(y_t), jnp.asarray(y0), t,
                                   interpret=True, matmul_dtype=mm, tile_m=32))
    with torch.no_grad():
        got = fused_tmdm_denoiser(port, _t(y_t), _t(y0), t, matmul_dtype=mm)
        rows = torch.cat([_t(y_t), _t(y0)], dim=-1).reshape(-1, 2 * F_)
        twin = fused_tmdm_rows_reference(rows, tmdm_gammas(port, t), tmdm_weights(port), mm)
        plain = port(None, _t(y_t), _t(y0), t)
    assert got.shape == want.shape == (5, 9, F_)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_array_equal(twin.reshape(5, 9, F_).numpy(), got.numpy())
    # the drop-in against the plain module of the port
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5 if mm == "float32" else 5e-2)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    _, _, port = _denoiser_pair(1, True, True)
    x = torch.zeros(8, 2)
    gam, w = tmdm_gammas(port, 0), tmdm_weights(port)
    with pytest.raises(ValueError):
        fused_tmdm_rows(x.to("meta"), gam, w)
    with pytest.raises(ValueError):
        fused_tmdm_rows(x, gam, w, matmul_dtype="float16")
    # the CPU path never touches the kernel
    fused_tmdm_rows(x, gam, w)
    assert fused_tmdm_rows.launches == 0


def test_ns_transformer_vae():
    """Deterministic mode against flax: pred, dec_out, kl_z and z_sample at
    atol 1e-4 (float32 sums in another order through ~10 layers); the
    reparameterised mode draws from its generator and leaves z_mean's KL."""
    W, P, N = TINY["windows"], TINY["pred_len"], 1
    kw = dict(seq_len=W, label_len=W // 2, pred_len=P, enc_in=N, d_model=16, n_heads=2,
              e_layers=1, d_layers=1, d_ff=32, p_hidden_dims=(8, 8), p_hidden_layers=2)
    x = _windows(3, seed=2)
    jm = JVAE(**kw, dropout=0.0)
    params = jax.jit(jm.init)({"params": jax.random.key(1)}, jnp.asarray(x))["params"]
    want = jax.jit(lambda p, b: jm.apply({"params": p}, b, deterministic=True))(
        params, jnp.asarray(x))
    port = _load_flax(NSTransformerVAE(**kw), params)
    with torch.no_grad():
        got = port(_t(x))
        g = torch.Generator().manual_seed(0)
        a = port(_t(x), deterministic=False, generator=g)
        b = port(_t(x), deterministic=False, generator=g)
    assert got[0].shape == (3, P, N) and got[1].shape == (3, W // 2 + P, N)
    for name, g_, w_ in zip(("pred", "dec_out", "kl_z", "z_sample"), got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert not torch.equal(a[3], b[3]) and not torch.equal(a[3], got[3])
    torch.testing.assert_close(a[2], got[2])


def test_state_dict_round_trip_jax_port_jax():
    jm = JTMDM(TINY, seed=3)
    jm.scaler_fit(np.linspace(0, 2, 50, dtype=np.float32).reshape(-1, 1))
    sd = jm.state_dict()
    port = diffusion_models("TMDM", TINY, device="cpu")
    assert isinstance(port, TMDMModel)
    port.load_state_dict(sd, strict=True)
    back = port.state_dict()
    assert set(back) == set(sd)
    assert {k.split(".")[0] for k in sd} == {
        "cond_pred_model", "enc_embedding", "model", "scaler_mean", "scaler_std"}
    for k in sd:
        np.testing.assert_array_equal(back[k], np.asarray(sd[k]), err_msg=k)
    JTMDM(TINY, seed=4).load_state_dict(back, strict=True)
    with pytest.raises(RuntimeError):
        port.load_state_dict({k: v for k, v in sd.items() if k != "model.lin4.bias"})
    # an unknown family raises the JAX factory's ValueError
    with pytest.raises(ValueError, match="the definition don't exit"):
        diffusion_models("DiffusionTS_v2", TINY, device="cpu")


def _jax_normals(key, S, T, shape):
    """The normals TMDMModel.sample_fn draws (tmdm.py:155,209 and
    ops/diffusion.py:216-242): kr, ks = split(key); one key per sample from
    split(ks, S); per sample z_T from the second half of a split, then one
    key per step t = T-1 .. 1."""
    _, ks = jax.random.split(key)

    def draws(k):
        k, k0 = jax.random.split(k)
        z_T = jax.random.normal(k0, shape, jnp.float32)
        steps = jax.random.split(k, T - 1)
        return z_T, jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float32))(steps)

    z_T, zs = jax.vmap(draws)(jax.random.split(ks, S))
    zs = np.array(zs)
    return [np.array(z_T)] + [zs[:, i] for i in range(T - 1)]


@pytest.mark.parametrize("schedule", ["linear", "quad"])
def test_sample_fn_matches_jax_under_shared_noise(schedule):
    """Per sample, rtol 1e-4 / atol 1e-5: float32 on both sides, sums in
    another order, carried through the reverse steps."""
    net = dict(TINY, beta_schedule=schedule)
    jm = JTMDM(net)
    port = TMDMModel(net, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    x = _windows(3, seed=7)
    key = jax.random.key(11)
    S, L = 4, TINY["windows"] // 2 + TINY["pred_len"]
    want = np.asarray(jax.jit(lambda p, b, k: jm.sample_fn(p, b, k, S))(
        jm.params, jnp.asarray(x), key))
    noise = _jax_normals(key, S, STEPS, (3, L, 1))
    got = port.sample_fn(torch.from_numpy(x), n_z_samples=S, noise=noise).numpy()
    assert got.shape == want.shape == (3, TINY["pred_len"], 1, S)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cat_x_layout_runs_the_plain_module():
    """Without cat_y_pred there is no kernel: the chain runs the plain
    denoiser on concat(y_t, x_emb), which needs W == label_len + pred_len."""
    net = dict(TINY, pred_len=12, label_len=12, cat_y_pred=False, cat_x=True)
    jm = JTMDM(net)
    port = TMDMModel(net, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    x = _windows(2, seed=8)
    key = jax.random.key(5)
    want = np.asarray(jax.jit(lambda p, b, k: jm.sample_fn(p, b, k, 2))(
        jm.params, jnp.asarray(x), key))
    got = port.sample_fn(torch.from_numpy(x), n_z_samples=2,
                         noise=_jax_normals(key, 2, STEPS, (2, 24, 1))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="cat_y_pred"):
        port.denoiser_fn(torch.zeros(2, 24, 1), torch.zeros(2, 24, 16), use_kernel=True)


def test_ensemble_mpv_close_to_jax_with_own_generator():
    """Each side draws its own noise (S = 64, 64 windows x 12 steps): the MPV
    is a mean of 768 independent sample variances, each with relative
    standard deviation sqrt(2 / 63) = 0.18, so either side's MPV scatters by
    0.18 / sqrt(768) = 0.64% and their difference by 0.9%; the 5% bar is
    more than five of those."""
    S = 64
    jm = JTMDM(TINY)
    port = TMDMModel(TINY, seed=1, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    x = _windows(64, seed=9)
    want = np.asarray(jax.jit(lambda p, b, k: jm.sample_fn(p, b, k, S))(
        jm.params, jnp.asarray(x), jax.random.key(2)))
    got = port.sample_fn(torch.from_numpy(x), n_z_samples=S).numpy()
    mpv_w, mpv_g = want.var(axis=-1).mean(), got.var(axis=-1).mean()
    assert np.isfinite(got).all() and mpv_g > 0
    np.testing.assert_allclose(mpv_g, mpv_w, rtol=0.05)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=0.01)


def test_bf16_sampling_dtype_on_the_cpu():
    """The default sampling_dtype casts the plain denoiser to bf16 on the
    CPU and keeps the chain float32, as the JAX package's default arm."""
    net = {k: v for k, v in TINY.items() if k != "sampling_dtype"}
    port = TMDMModel(net, device="cpu")
    out, batch_y = port.evaluation_step(_windows(2, seed=3))
    assert out.dtype == torch.float32 and out.shape == (2, 12, 1, 4) and batch_y is None
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="sampling_dtype"):
        TMDMModel(dict(net, sampling_dtype="fp32"), device="cpu").evaluation_step(
            _windows(1, seed=3))
