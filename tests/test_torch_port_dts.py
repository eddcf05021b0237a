"""DiffusionTS held against the JAX package (CPU): the schedule and the DDIM
pairs bit for bit, the x0 helpers, the attention and embedding blocks, both
routes of the FourierLayer, the denoising transformer, the loss and its
gradients, the DDIM infill sampler with the Langevin corrector off (per
sample) and on (ensemble), unconditional generation, bf16 sampling,
checkpoints both ways, the time-series CLI and the generic branch of
``uncertainty_ews`` with the cache runner's flush interval.

Both packages run on the same weights (the port's, drawn from a seed, or
seeded normals in the tree of the JAX module's init, shapes by
``jax.eval_shape``); the JAX models skip their init and hold those weights.
The timesteps and normals JAX draws from its keys reach the port through the
seams of ``loss_fn`` and the samplers. One JAX sampler run per corrector
setting is shared through module-scoped fixtures: the JAX Langevin scan
compiles a gradient of the transformer, and that compile dominates.
Sizes: W/P 24/8, d_model 16, one encoder and one decoder layer, 10
timesteps and 10 DDIM steps.
"""
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from upgdm_tpu.models import attention as jatt
from upgdm_tpu.models import diffusionts_net as jnet
from upgdm_tpu.models import embedding as jemb
from upgdm_tpu.models.diffusionts import DiffusionTSModel as JDTS
from upgdm_tpu.ops import diffusion as JD
from upgdm_tpu.ops import schedules as jsched
from upgdm_tpu.utils import io as jio
from upgdm_tpu.utils.io import flatten_params, unflatten_params
from upgdm_tpu_torch.cli import train_timeseries
from upgdm_tpu_torch.eval import uncertainty as PU
from upgdm_tpu_torch.models import attention, diffusionts_net, embedding
from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel
from upgdm_tpu_torch.models.layers import gelu, gelu2
from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops import schedules
from upgdm_tpu_torch.utils import io as pio
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch, torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
W, P, STEPS = 24, 8, 10
T = W + P
NET = dict(
    dataset_nf=1, windows=W, pred_len=P, timesteps=STEPS, diffusion_steps=STEPS,
    beta_schedule="cosine", n_layer_enc=1, n_layer_dec=1, d_model=16, n_heads=2,
    mlp_hidden_times=4, n_z_samples=16, parallel_sample=8, eta=0.0, infill_coef=0.1,
    infill_learning_rate=0.05, task_model="DiffusionTS", sampling_dtype="float32",
    scaler_type=None,
)
# the bars of the port's module tests (tests/test_torch_port_graph.py), of its
# losses and gradients (tests/test_torch_port_train.py), of a sampled chain
# (tests/test_torch_parity.py) and of two sampling dtypes (tests/test_models_e2e.py)
ATOL, LOSS_RTOL, GRAD_REL = 1e-5, 1e-4, 1e-3
SAMPLE_RTOL, SAMPLE_ATOL, MPV_REL = 2e-4, 2e-5, 0.01


def _seeded_params(module, seed, *args, **kw):
    """Seeded normal weights (std 0.3) in the tree of ``module.init``."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kw)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * 0.3).astype(np.float32)), shapes)


def _carry(port_module, params, name="m"):
    """JAX params -> the port's module (strict), names checked both ways."""
    flat = flatten_params({name: params})
    holder = torch.nn.ModuleDict({name: port_module})
    holder.load_state_dict(torch_state_from_flax(flat), strict=True)
    assert sorted(flax_flat_from_torch(holder.state_dict())) == sorted(flat)
    return port_module


def _weights(port):
    return {k: v for k, v in port.state_dict().items() if not k.startswith("scaler")}


def jax_model(net, flat):
    """JAX's DiffusionTSModel(net) holding the flat weights ``flat``, or
    zeros in its own tree (by ``jax.eval_shape``) with ``flat`` None."""

    def init(self):
        if flat is None:
            x, t = jnp.zeros((1, self.seq_length, self.dataset_nf)), jnp.zeros((1,), jnp.int32)
            shapes = jax.eval_shape(self.net.init, jax.random.key(0), x, t)["params"]
            self.params = {"model": jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)}
        else:
            self.params = jax.tree.map(jnp.asarray, unflatten_params(dict(flat)))

    with mock.patch.object(JDTS, "_init_params", init):
        return JDTS(net)


def _close(got, want):
    """Within ATOL of the reference's scale (its largest |value|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=ATOL * np.abs(want).max())


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("kind,steps", [("cosine", 100), ("linear", 100), ("cosine", 10)])
def test_schedule_bit_equal(kind, steps):
    got, want = schedules.diffusionts_schedule(kind, steps), jsched.diffusionts_schedule(kind,
                                                                                      steps)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
              "loss_weight"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.num_timesteps == steps
    with pytest.raises(ValueError):
        schedules.diffusionts_schedule("quad", 10)


@pytest.mark.parametrize("total,sampling", [(100, 100), (100, 20), (10, 10), (50, 7), (8, 3)])
def test_ddim_time_pairs_equal(total, sampling):
    assert schedules.ddim_time_pairs(total, sampling) == jsched.ddim_time_pairs(total, sampling)


def test_x0_helpers_match_jax():
    """q_sample, the noise from a predicted x0 and the posterior, per-row t."""
    sched = schedules.diffusionts_schedule("cosine", 20)
    rng = np.random.default_rng(0)
    x0, xt, eps = (rng.normal(size=(3, 5, 2)).astype(np.float32) for _ in range(3))
    t = np.array([0, 7, 19])
    js = jsched.diffusionts_schedule("cosine", 20)
    tt = torch.from_numpy(t)
    _close(D.dts_q_sample(torch.from_numpy(x0), sched, tt, torch.from_numpy(eps)),
           JD.dts_q_sample(x0, js, t, eps))
    _close(D.dts_predict_noise_from_start(torch.from_numpy(xt), sched, tt, torch.from_numpy(x0)),
           JD.dts_predict_noise_from_start(xt, js, t, x0))
    for g, w in zip(D.dts_q_posterior(sched, torch.from_numpy(x0), torch.from_numpy(xt), tt),
                    JD.dts_q_posterior(js, x0, xt, t)):
        _close(g, w)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("kind", ["full", "cross"])
def test_attention_matches_jax(kind):
    """Output and head-averaged map of DiffusionTS's attention, with and
    without a key mask."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 8)).astype(np.float32)
    cond = rng.normal(size=(2, 5, 6)).astype(np.float32)
    if kind == "full":
        jm, pm, args = jatt.FullAttention(8, 2), attention.FullAttention(8, 2), (x,)
        mask = np.arange(7)[None] < np.array([7, 4])[:, None]
    else:
        jm, pm, args = (jatt.CrossAttention(8, 6, 2), attention.CrossAttention(8, 6, 2),
                        (x, cond))
        mask = np.arange(5)[None] < np.array([5, 2])[:, None]
    params = _seeded_params(jm, 2, *args)
    _carry(pm, params)
    for m in (None, mask):
        want = jm.apply({"params": params}, *args, mask=m)
        with torch.no_grad():
            got = pm(*map(torch.from_numpy, args),
                     mask=None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("block", ["pos_encoding", "ada_layer_norm", "trend", "gelu"])
def test_small_blocks_match_jax(block):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 8)).astype(np.float32)
    t = np.array([0, 9], np.int32)
    if block == "gelu":
        _close(gelu(torch.from_numpy(x)), jnet._ACT["GELU"](x))
        _close(gelu2(torch.from_numpy(x)), jnet._ACT["GELU2"](x))
        return
    if block == "pos_encoding":
        jm, pm, args = (jemb.LearnablePositionalEncoding(8, 12),
                        embedding.LearnablePositionalEncoding(8, 12), (x,))
        fresh = pm.pe.detach().numpy()
        assert np.abs(fresh).max() <= 0.02 and fresh.std() > 0.005  # U(-0.02, 0.02)
    elif block == "ada_layer_norm":
        jm, pm, args = jnet.AdaLayerNorm(8), diffusionts_net.AdaLayerNorm(8), (x, t)
    else:
        jm, pm, args = (jnet.TrendBlock(12, 3), diffusionts_net.TrendBlock(12, 8, 12, 3), (x,))
    params = _seeded_params(jm, 4, *args)
    _carry(pm, params)
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, args))
    _close(got, jm.apply({"params": params}, *args))


@pytest.mark.parametrize("route", ["rfft", "dft_matmul"])
@pytest.mark.parametrize("length", [32, 31])
def test_fourier_layer_both_routes_match_jax(route, length):
    """The top-k extrapolation by rfft + cosines and by DFT matmuls, each
    forced on both sides (even and odd lengths): output at atol 1e-5 of its
    scale, and the input gradient of a weighted sum (the Langevin corrector
    differentiates through it) within 1e-3 of its largest entry; the two
    routes agree with each other. The default takes the rfft on the CPU."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, length, 4)).astype(np.float32)
    wts = rng.normal(size=x.shape).astype(np.float32)
    mm = route == "dft_matmul"
    jm = jnet.FourierLayer(4, use_dft_matmul=mm)
    want = np.asarray(jm.apply({}, x))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jm.apply({}, a) * wts))(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = diffusionts_net.FourierLayer(use_dft_matmul=mm)(xt)
    (got * torch.from_numpy(wts)).sum().backward()
    _close(got.detach(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0,
                               atol=GRAD_REL * np.abs(want_g).max())
    other = diffusionts_net.FourierLayer(use_dft_matmul=not mm)(torch.from_numpy(x))
    _close(other, want)
    default = diffusionts_net.FourierLayer()
    assert not default._route_matmul(torch.from_numpy(x))
    assert default._route_matmul(torch.empty(0, device="meta"))


@pytest.mark.parametrize("kernel,route", [(None, False), (5, False), (5, True)])
def test_transformer_matches_jax(kernel, route):
    """DTSTransformer (two decoder layers) on seeded weights: trend and
    season at atol 1e-5 of their scale; k 5 exercises the circular
    combine_s; one case on the DFT-matmul route (forced on both sides)."""
    rng = np.random.default_rng(6)
    kw = dict(n_feat=1, n_channel=T, n_layer_enc=1, n_layer_dec=2, n_embd=16, n_heads=2,
              conv_kernel=kernel)
    x = rng.normal(size=(3, T, 1)).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    jm = jnet.DTSTransformer(**kw)
    params = _seeded_params(jm, 7, x, t)
    # the JAX layer picks its route by the backend when it traces
    with mock.patch.object(jnet.jax, "default_backend", lambda: "gpu" if route else "cpu"):
        want = jax.jit(lambda p: jm.apply({"params": p}, x, t))(params)
    pm = _carry(diffusionts_net.DTSTransformer(**kw), params)
    assert pm.k == (kernel or 1)
    for i in range(2):
        getattr(pm, f"dec_{i}").seasonal.use_dft_matmul = route
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t))
    for g, w in zip(got, want):
        assert g.shape == (3, T, 1)
        _close(g, w)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("loss_type,use_ff", [("l2", True), ("l1", False)])
def test_loss_and_gradients_match_jax(loss_type, use_ff):
    """The training loss on JAX's t and normals: rtol 1e-4, every gradient
    leaf within 1e-3 of its largest |jax.grad|."""
    net = dict(NET, loss_type=loss_type, use_ff=use_ff)
    port = DiffusionTSModel(net, seed=1, device="cpu")
    jm = jax_model(net, _weights(port))
    assert port.ff_weight == jm.ff_weight == math.sqrt(T) / 5
    rng = np.random.default_rng(8)
    batch = rng.normal(size=(4, T, 1)).astype(np.float32)
    key = jax.random.key(3)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, key, train=True)))(jm.params)
    _, kt, ke = jax.random.split(key, 3)
    loss = port.loss_fn(batch, t=np.asarray(jax.random.randint(kt, (4,), 0, STEPS)),
                        noise=np.asarray(jax.random.normal(ke, batch.shape)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    got = flax_flat_from_torch({n: p.grad for n, p in port.net.named_parameters()})
    want = flatten_params(grads_j)
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=GRAD_REL * top,
                                   err_msg=k)
    assert port.trainable_mask() == jm.trainable_mask() == {"model": True}


def _jax_infill_draws(key, S, shape, n_scan):
    """The normals of JAX's sample_fn for ``key``: the initial state [S,
    *shape], the DDIM noise and the target's noise [n_scan, S, *shape]."""

    def one(k):
        k, k0 = jax.random.split(k)
        keys = jax.random.split(k, n_scan + 1)[:n_scan]
        kn = jax.vmap(lambda kk: jax.random.normal(jax.random.split(kk, 3)[0], shape))(keys)
        kq = jax.vmap(lambda kk: jax.random.normal(jax.random.split(kk, 3)[2], shape))(keys)
        return jax.random.normal(k0, shape), kn, kq

    img, kn, kq = (np.asarray(a) for a in jax.vmap(one)(jax.random.split(key, S)))
    return img, kn.swapaxes(0, 1), kq.swapaxes(0, 1)


def _jax_run(lr, S=16, B=8, sampling="float32"):
    """(port model, history [B, W, 1], JAX's ensemble [B, P, 1, S], JAX's
    draws) for one corrector setting on the port's weights."""
    net = dict(NET, infill_learning_rate=lr, sampling_dtype=sampling)
    port = DiffusionTSModel(net, seed=2, device="cpu")
    jm = jax_model(net, _weights(port))
    rng = np.random.default_rng(9)
    hist = (rng.normal(size=(B, W, 1)) * 0.3).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jax.jit(lambda p: jm.sample_fn(p, hist, key, S))(jm.params))
    return port, hist, want, _jax_infill_draws(key, S, (B, T, 1), STEPS - 1)


@pytest.fixture(scope="module")
def langevin_off():
    return _jax_run(0.0)


@pytest.fixture(scope="module")
def langevin_on():
    return _jax_run(0.05)


def test_sampler_with_langevin_off_matches_jax_per_sample(langevin_off):
    """``infill_learning_rate`` 0: the DDIM infill of 16 members (two chunks
    of ``parallel_sample`` 8) on JAX's draws, output [B, P, F, S]. Every
    sample is within rtol 2e-4 / atol 2e-5 of the chain run with the
    transformer in float64 (the same draws; the exact arithmetic of the
    float32 samplers), and of JAX's wherever JAX's is itself within that bar
    of it: the clamped chain amplifies rounding, and at the elements where
    the port and JAX part (2 of 1,024 here, by 1.2e-4) it is JAX's float32
    chain that is off the float64 one (by 1.2e-4, the port's by 4.4e-5). The
    port's own draws give another, finite ensemble."""
    port, hist, want, draws = langevin_off
    got = port.sample_fn(hist, n_z_samples=16, noise=draws).numpy()
    assert got.shape == want.shape == (8, P, 1, 16)
    exact = DiffusionTSModel(dict(NET, infill_learning_rate=0.0), seed=2, device="cpu")
    exact.net.double()
    ref = exact.sample_fn(hist, n_z_samples=16, noise=draws).numpy()
    np.testing.assert_allclose(got, ref, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    jax_ok = np.abs(want - ref) <= SAMPLE_ATOL + SAMPLE_RTOL * np.abs(ref)
    assert jax_ok.mean() > 0.99
    np.testing.assert_allclose(got[jax_ok], want[jax_ok], rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    own = port.sample_fn(hist, n_z_samples=3).numpy()
    assert own.shape == (8, P, 1, 3) and np.isfinite(own).all()
    assert np.abs(own[..., 0] - got[..., 0]).max() > 0


def test_sampler_with_langevin_on_matches_jax_ensemble(langevin_on):
    """The corrector on (K 1-2 steps of lr sign(g) at 9 of the 10 DDIM steps)
    on JAX's draws: ensemble MPV within 1%, and at most 0.1% of the 1,024
    future elements off the sample bar (a gradient that crosses zero moves
    an element by 2 lr). The corrector does run: the samples differ from the
    corrector-off run on the same draws."""
    port, hist, want, draws = langevin_on
    got = port.sample_fn(hist, n_z_samples=16, noise=draws).numpy()
    mpv, mpv_j = got.var(axis=-1).mean(), want.var(axis=-1).mean()
    assert abs(mpv - mpv_j) / mpv_j < MPV_REL
    off = np.abs(got - want) > SAMPLE_ATOL + SAMPLE_RTOL * np.abs(want)
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} elements off"
    port.infill_lr = 0.0
    try:
        no_corr = port.sample_fn(hist, n_z_samples=16, noise=draws).numpy()
    finally:
        port.infill_lr = 0.05
    assert np.abs(no_corr - got).max() > 1e-3


def test_langevin_gradient_runs_outside_inference_mode(langevin_on):
    """The corrector differentiates with respect to the chain state alone
    (no gradient reaches the weights) and refuses to run under
    ``torch.inference_mode``, whose tensors cannot be saved for backward."""
    port, hist, _, _ = langevin_on
    port.net.zero_grad(set_to_none=True)
    with mock.patch.object(torch.autograd, "grad", wraps=torch.autograd.grad) as spy:
        out = port.sample_fn(hist[:2], n_z_samples=2)
    assert np.isfinite(out.numpy()).all()
    # one call for both members: K = 2 at times 8 and 9, 1 at times 1..7
    assert spy.call_count == 2 * 2 + 7
    assert all(p.grad is None for p in port.net.parameters())
    with torch.inference_mode(), pytest.raises(RuntimeError):
        port.sample_fn(hist[:2], n_z_samples=2)


def test_bf16_sampling_mpv():
    """bf16 sampling (a cast copy of the transformer; chain, posterior and
    corrector float32) at the configuration of the JAX package's own
    DiffusionTS bar (tests/test_models_e2e.py:174-210: S 96 with the
    corrector on, 5%): the lr sign(g) chain and the +-1 clamp decorrelate
    same-draw trajectories under any perturbation, so the bar is statistical
    and wider than NsDiff's 1%."""
    cfg = dict(dataset_nf=1, windows=24, pred_len=8, diffusion_steps=10, timesteps=20,
               scaler_type=None, d_model=32, n_heads=2, n_layer_enc=1, n_layer_dec=2,
               n_z_samples=96, parallel_sample=96, task_model="DiffusionTS")
    x = np.random.default_rng(0).normal(size=(4, 24, 1)).astype(np.float32)
    m32 = DiffusionTSModel(dict(cfg, sampling_dtype="float32"), seed=0, device="cpu")
    m16 = DiffusionTSModel(cfg, seed=0, device="cpu")
    assert m16.sampling_dtype() == torch.bfloat16
    e32 = m32.sample_fn(x, torch.Generator().manual_seed(7)).numpy()
    e16 = m16.sample_fn(x, torch.Generator().manual_seed(7)).numpy()
    assert np.isfinite(e16).all() and np.abs(e16 - e32).max() > 0
    assert abs(e16.var(axis=-1).mean() / e32.var(axis=-1).mean() - 1) < 0.05


def test_generate_mts_matches_jax():
    """Unconditional DDIM generation on JAX's draws (eta 0.5, so the DDIM
    noise counts), float32."""
    net = dict(NET, eta=0.5)
    port = DiffusionTSModel(net, seed=4, device="cpu")
    jm = jax_model(net, _weights(port))
    key = jax.random.key(2)
    want = np.asarray(jax.jit(lambda p: jm.generate_mts_fn(p, key, 3))(jm.params))
    k, k0 = jax.random.split(key)
    zs = np.stack([np.asarray(jax.random.normal(kk, (3, T, 1)))
                   for kk in jax.random.split(k, STEPS - 1)])
    got = port.generate_mts_fn(batch_size=3,
                               noise=(np.asarray(jax.random.normal(k0, (3, T, 1))), zs)).numpy()
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


def test_checkpoints_load_both_ways(tmp_path):
    """The port's ``model_trained`` loads strictly into JAX's model (its own
    tree), and JAX's into the port's through ``load_model_from_dir``, bit
    for bit, with the scaler."""
    port = DiffusionTSModel(dict(NET, scaler_type="StandardScaler"), seed=5, device="cpu")
    port.scaler_fit(np.random.default_rng(1).normal(size=(6, T, 1)))
    pio.save_checkpoint(tmp_path / "p", "model_trained", port.state_dict(), NET)
    _, sd = jio.load_checkpoint(tmp_path / "p/model_trained")
    jm = jax_model(NET, None)
    jm.load_state_dict(sd, strict=True)
    for k, v in flatten_params(jm.params).items():
        np.testing.assert_array_equal(np.asarray(v), _weights(port)[k], err_msg=k)
    jm.params = jax.tree.map(lambda a: a * 0.5 + 0.1, jm.params)
    jio.save_checkpoint(tmp_path / "j", "model_trained", jm.state_dict(), NET)
    (tmp_path / "j/model_trained.yaml").write_text(yaml.safe_dump({"net": NET}))
    back, _ = PU.load_model_from_dir(tmp_path / "j", device="cpu")
    assert isinstance(back, DiffusionTSModel)
    for k, v in flatten_params(jm.params).items():
        np.testing.assert_array_equal(back.state_dict()[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(back.scaler_std, port.scaler_std)
    with pytest.raises(RuntimeError):
        back.load_state_dict({k: v for k, v in sd.items() if k != "model.pos_enc.pe"})


def test_train_timeseries_cli_hold_out_loads_into_jax(tmp_path):
    """``cli.train_timeseries --train_mode hold_out --device cpu`` with the
    DiffusionTS grid config (cut to one epoch on a small corpus): records,
    and a checkpoint that loads strictly into JAX, whose loss on its draws
    equals the port's."""
    rng = np.random.default_rng(2)
    data = tmp_path / "data"
    for i in range(2):
        n = 400
        ys = (rng.normal(size=(n, 1)) * 0.05).cumsum(axis=0).astype(np.float32) + 1
        pio.save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(n, dtype=np.float32),
                     "tp_values": np.zeros(n, np.float32)}, data / f"rec_{i}" / "r.pt")
    with open(REPO / "configs/grid_search/diffusion_model_DiffusionTS.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["out_dir"] = str(tmp_path / "out")
    cfg["dataset"].update(file_path=[str(data)], sampling_t=[0.1], windows=[W], pred_len=[P],
                          interval_step=[20])
    cfg["train"].update(train_epochs=[1], train_batch_size=[8], val_batch_size=[8])
    cfg["net"].update(timesteps=[STEPS], diffusion_steps=[STEPS], n_layer_enc=[1],
                      n_layer_dec=[1], d_model=[16], n_heads=[2])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_timeseries.main(["--cfg", str(path), "--train_mode", "hold_out", "--device", "cpu"])
    ckpt = tmp_path / "out/hold_out/trained_model/model_trained"
    net_param, sd = jio.load_checkpoint(ckpt)
    assert net_param["task_model"] == "DiffusionTS" and net_param["windows"] == W
    jm = jax_model(net_param, None)
    jm.load_state_dict(sd, strict=True)
    port, _ = PU.load_model_from_dir(ckpt.parent, device="cpu")
    batch = rng.normal(size=(3, T, 1)).astype(np.float32)
    key = jax.random.key(1)
    want = float(jax.jit(lambda p: jm.loss_fn(p, batch, key, train=False))(jm.params))
    _, kt, ke = jax.random.split(key, 3)
    got = port.loss_fn(batch, train=False, t=np.asarray(jax.random.randint(kt, (3,), 0, STEPS)),
                       noise=np.asarray(jax.random.normal(ke, batch.shape))).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_facade_generic_branch_with_the_cache_runner(tmp_path):
    """``uncertainty_ews`` on a DiffusionTS checkpoint and a network record
    (6 nodes): the generic branch, windows chunked to ``eval_rows_per_call``
    // nodes, the cache runner flushing its partial every
    ``eval_checkpoint_every`` windows; a second call is a cache hit with no
    sampling, the same MPV."""
    net = dict(NET, scaler_type="StandardScaler", n_z_samples=4, parallel_sample=2,
               eval_rows_per_call=12)
    model = DiffusionTSModel(net, seed=6, device="cpu")
    rng = np.random.default_rng(3)
    n_t = 200
    ys = (rng.normal(size=(n_t, 6)) * 0.05).cumsum(axis=0).astype(np.float32) + 0.5
    model.scaler_fit(ys.reshape(-1, 1))
    mdir = tmp_path / "model"
    pio.save_checkpoint(mdir, "model_trained", model.state_dict(), net)
    pio.save_config_yaml(mdir / "model_trained.yaml", {
        "dataset": {"windows": W, "pred_len": P, "sampling_t": 0.1},
        "train": {"train_model_select": None}, "net": net})
    data = tmp_path / "SIS_dynamic_increase.pt"
    pio.save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(n_t, dtype=np.float32),
                 "tp_values": np.zeros(n_t, np.float32)}, data)
    (tmp_path / "c").mkdir()
    calls = []
    run = PU.run_evaluation_cache

    def spy(*a, **kw):
        calls.append((kw["chunk_windows"], kw["checkpoint_every"]))
        return run(*a, **kw)

    kw = dict(model_save_file=mdir, data_file=data, dynamic_type="SIS", cache_path=tmp_path / "c",
              device="cpu", max_windows=5, sample_window_step=20)
    with mock.patch.object(PU, "run_evaluation_cache", spy), \
            mock.patch.object(PU, "_flush_partial", wraps=PU._flush_partial) as flush, \
            mock.patch.object(DiffusionTSModel, "sample_fn",
                              wraps=DiffusionTSModel.sample_fn, autospec=True) as sampled:
        first = PU.uncertainty_ews(**kw)
        n_sampled = sampled.call_count
        hit = PU.uncertainty_ews(**kw)
    assert calls == [(2, 4)]  # 12 rows // 6 nodes; the JAX package's flush interval
    assert flush.call_count == 1  # after 4 of the 5 windows
    assert n_sampled == 3 * 2 and sampled.call_count == n_sampled  # 3 chunks x 2 rounds
    assert first["task_model"] == "DiffusionTS" and len(first["ews"]) == 5
    assert np.isfinite(first["ews"]).all() and (np.asarray(first["ews"]) > 0).all()
    assert hit["ews"] == first["ews"]
    assert first["pred_future_list"][0].shape == (6, P, 1, 4)
