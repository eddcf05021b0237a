"""The port's utilities against the JAX package's (CPU): the reference
checkpoint importer (``utils/torch_import.py`` and each wrapper's
``convert_reference_state_dict``), the profiling hooks, the simple and CEP
losses with the evaluation scores, the supervised vanilla loop, the curve
plots, the package's lazy exports, and the imports of the new modules.

As in the JAX package's own tests, the reference-format dicts are built from
models through the inverse layout transforms; every converted dict is held to
the JAX package's conversion of the same dict. The CEP Gaussian process and
CEPLoss's timesteps draw from a ``torch.Generator``: they are held to JAX with
JAX's draws passed in, and at the distribution level from the generator.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.models.diffstg import DiffSTGModel as JDiffSTG
from upgdm_tpu.models.diffusionts import DiffusionTSModel as JDTS
from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
from upgdm_tpu.models.tmdm import TMDMModel as JTMDM
from upgdm_tpu.train import losses as JL
from upgdm_tpu.utils import profiling as JP
from upgdm_tpu.utils import torch_import as JT
from upgdm_tpu.utils.io import flatten_params
from upgdm_tpu_torch.models.diffstg import DiffSTGModel
from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.models import ugnet
from upgdm_tpu_torch.models.layers import LayerNorm
from upgdm_tpu_torch.train import losses as PL
from upgdm_tpu_torch.train.vanilla import deg_histogram, run_training_vanilla
from upgdm_tpu_torch.utils import profiling as PP
from upgdm_tpu_torch.utils import torch_import as PT
from upgdm_tpu_torch.utils.weights import SCALER_KEYS, torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]

NET_PARAM = dict(
    dataset_nf=1, windows=16, pred_len=8, rolling_length=8, diffusion_steps=4,
    diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2,
    scaler_type=None, d_model=16, n_heads=2, e_layers=2, d_layers=1, d_ff=32,
    dropout=0.0, p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=4,
    parallel_sample=2, task_model="NsDiff", load_pretrain=False,
    freeze_pretrain=False, output_attention=False, factor=3, activation="gelu",
)
TMDM_PARAM = {k: v for k, v in dict(NET_PARAM, task_model="TMDM", timesteps=4, k_z=1e-2,
                                    k_cond=1.0).items() if k != "rolling_length"}
STG_PARAM = dict(
    T_h=8, T_p=8, F=1, diffusion_steps=10, inference_diffusion_steps=3,
    diffusion_schedule="linear", scaler_type=None, d_h=4, Td_h=8,
    channel_multipliers=[1, 2], n_blocks=2, gnn_name="GCNConv",
    parallel_sampling=2, sequential_sampling=2, init_num_nodes=6, task_model="DiffSTG",
)
DTS_PARAM = dict(
    dataset_nf=2, windows=16, pred_len=8, diffusion_steps=4, timesteps=8,
    d_model=16, n_heads=2, n_layer_enc=1, n_layer_dec=2, n_z_samples=2,
    scaler_type=None, task_model="DiffusionTS",
)

# inverse layout transforms (flax -> torch reference) to synthesize reference dicts
INV = {
    "linear": lambda k: np.asarray(k).T,
    "conv1d": lambda k: np.transpose(np.asarray(k), (2, 1, 0)),
    "ffn_conv": lambda k: np.asarray(k).T[..., None],
    "time_conv": lambda k: np.asarray(k)[..., None],
    "copy": lambda k: np.asarray(k),
    "squeeze_copy": lambda a: np.asarray(a)[None, :],
    "conv2d_1x1": lambda a: np.asarray(a).T[:, :, None, None],
    "conv2d_midrow": lambda a: (
        np.stack([np.zeros_like(a.transpose(2, 1, 0)), a.transpose(2, 1, 0),
                  np.zeros_like(a.transpose(2, 1, 0))], axis=2)
        if a.shape[0] == 3 else a.transpose(2, 1, 0)[:, :, None, :]),
    "convtranspose2d_time": lambda a: np.asarray(a)[::-1].transpose(1, 2, 0)[:, :, None, :],
}


def _native(model):
    return {k: v for k, v in model.state_dict().items() if k not in SCALER_KEYS}


def _reference_dict(flat, key_map, prefix=""):
    return {prefix + tk: INV[tf](np.asarray(flat[fk])) for tk, (fk, tf) in key_map.items()}


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# -- the checkpoint importer ------------------------------------------------------------

def test_key_maps_are_jax_and_cover_the_port_models():
    nsdiff = NsDiffModel(NET_PARAM, device="cpu")
    key_map = PT.nsdiff_reference_key_map(2, 1, 2)
    assert key_map == JT.nsdiff_reference_key_map(2, 1, 2)
    assert {d for d, _ in key_map.values()} == set(_native(nsdiff))
    tmdm = TMDMModel(TMDM_PARAM, device="cpu")
    assert PT.tmdm_reference_key_map(2, 1, 2) == JT.tmdm_reference_key_map(2, 1, 2)
    assert {d for d, _ in PT.tmdm_reference_key_map(2, 1, 2).values()} == set(_native(tmdm))
    stg = DiffSTGModel(dict(STG_PARAM), device="cpu")
    assert PT.diffstg_reference_key_map(STG_PARAM) == JT.diffstg_reference_key_map(STG_PARAM)
    assert {d for d, _ in PT.diffstg_reference_key_map(STG_PARAM).values()} == set(_native(stg))
    dts = DiffusionTSModel(dict(DTS_PARAM), device="cpu")
    dts_map = PT.dts_reference_key_map(1, 2)
    assert dts_map == JT.dts_reference_key_map(1, 2)
    assert {d for d, _ in dts_map.values()} | {"model.combine_m.bias"} == set(_native(dts))


@pytest.fixture(scope="module")
def jax_nsdiff():
    return JNsDiff(NET_PARAM, seed=1)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_nsdiff_reference_dict_loads_as_jax_loads_it(jax_nsdiff, prefix):
    """A reference dict built from the JAX model (buffers included) loads
    into the port's model through ``load_state_dict``, to JAX's weights; the
    port's conversion is JAX's, ``module.`` prefixes stripped."""
    src = flatten_params(jax_nsdiff.params)
    ref = _reference_dict(src, PT.nsdiff_reference_key_map(2, 1, 2), prefix)
    ref[prefix + "cond_pred_model.enc_embedding.position_embedding.pe"] = np.zeros((1, 50, 16))
    assert PT.looks_like_reference_nsdiff_state_dict(ref)
    _assert_same_dict(PT.convert_reference_nsdiff_state_dict(ref, NET_PARAM),
                      JT.convert_reference_nsdiff_state_dict(ref, NET_PARAM))
    port = NsDiffModel(NET_PARAM, seed=2, device="cpu")
    before = _native(port)
    port.load_state_dict(ref)
    after = _native(port)
    assert any(not np.array_equal(before[k], after[k]) for k in after)
    _assert_same_dict(after, src)


def test_nsdiff_stage_converts_only_its_subtrees(jax_nsdiff):
    """A pretrain_g stage (g only) takes the g subtree of a reference dict."""
    ref = _reference_dict(flatten_params(jax_nsdiff.params), PT.nsdiff_reference_key_map(2, 1, 2))
    g_only = {k: v for k, v in ref.items() if k.startswith("cond_pred_model_g.")}
    port = NsDiffModel(NET_PARAM, train_model_select="pretrain_g", device="cpu")
    assert set(port.net) == {"cond_pred_model_g"}
    port.load_state_dict(g_only)
    want = {k: v for k, v in flatten_params(jax_nsdiff.params).items()
            if k.startswith("cond_pred_model_g.")}
    _assert_same_dict(_native(port), want)


def test_strict_mode_rejects_unknown_and_missing_keys(jax_nsdiff):
    ref = _reference_dict(flatten_params(jax_nsdiff.params), PT.nsdiff_reference_key_map(2, 1, 2))
    bad = dict(ref, **{"model.diffussion_model.lin9.lin.weight": np.zeros((4, 4))})
    incomplete = {k: v for k, v in ref.items() if k != "model.diffussion_model.lin4.weight"}
    for mod in (PT, JT):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.convert_reference_nsdiff_state_dict(bad, NET_PARAM)
        with pytest.raises(ValueError, match="missing"):
            mod.convert_reference_nsdiff_state_dict(incomplete, NET_PARAM)
    with pytest.raises(ValueError, match="unrecognized"):
        NsDiffModel(NET_PARAM, device="cpu").load_state_dict(bad)
    loose = PT.convert_reference_nsdiff_state_dict(incomplete, NET_PARAM, strict=False)
    _assert_same_dict(loose, JT.convert_reference_nsdiff_state_dict(incomplete, NET_PARAM,
                                                                   strict=False))


def test_native_state_dicts_pass_through_unchanged():
    model = NsDiffModel(NET_PARAM, seed=4, device="cpu")
    native = model.state_dict()
    assert not PT.looks_like_reference_nsdiff_state_dict(native)
    assert model.convert_reference_state_dict(native) is native
    other = NsDiffModel(NET_PARAM, seed=5, device="cpu")
    other.load_state_dict(native)
    _assert_same_dict(other.state_dict(), native)


def test_tmdm_reference_dict_loads_as_jax_loads_it():
    src = flatten_params(JTMDM(TMDM_PARAM, seed=1).params)
    ref = _reference_dict(src, PT.tmdm_reference_key_map(2, 1, 2))
    ref["model.enc_embedding.temporal_embedding.hour_embed.emb.weight"] = np.zeros((24, 16))
    _assert_same_dict(PT.convert_reference_tmdm_state_dict(ref, TMDM_PARAM),
                      JT.convert_reference_tmdm_state_dict(ref, TMDM_PARAM))
    port = TMDMModel(TMDM_PARAM, seed=2, device="cpu")
    port.load_state_dict(ref)
    _assert_same_dict(_native(port), src)


def test_diffstg_reference_dict_loads_as_jax_loads_it():
    """A reference-shaped UGnet dict (random values through the inverse
    transforms) strict-loads into both packages' models to the same
    weights, and the port samples finitely from it."""
    key_map = PT.diffstg_reference_key_map(STG_PARAM)
    port = DiffSTGModel(dict(STG_PARAM), device="cpu")
    shapes = {k: v.shape for k, v in _native(port).items()}
    rng = np.random.default_rng(0)
    sd = {tk: INV[tf]((rng.normal(size=shapes[dst]) * 0.05).astype(np.float32))
          for tk, (dst, tf) in key_map.items()}
    sd["scaler_mean"], sd["scaler_std"] = np.zeros(1, np.float32), np.ones(1, np.float32)
    port.load_state_dict(sd)
    jax_model = JDiffSTG(dict(STG_PARAM))
    jax_model.load_state_dict(sd)
    _assert_same_dict(_native(port), flatten_params(jax_model.params))
    for tk, (dst, tf) in key_map.items():
        np.testing.assert_array_equal(_native(port)[dst], PT._T[tf](sd[tk]))
    adj = (rng.uniform(size=(6, 6)) < 0.4).astype(np.float32)
    adj = ((adj + adj.T) > 0).astype(np.float32)
    x = rng.normal(size=(6, 16, 1)).astype(np.float32)
    outs, _ = port.evaluation_step({"x": x, "adj": adj})
    assert torch.isfinite(torch.as_tensor(outs)).all()


def _to4d(x):  # [N, T, C] -> torch [N, C, 1, T]
    return torch.from_numpy(x).permute(0, 2, 1).unsqueeze(2)


def _from4d(y):  # torch [N, C, 1, T] -> [N, T, C]
    return y.squeeze(2).permute(0, 2, 1).detach().numpy()


def _port_apply(module, flat, x):
    """``module`` loaded from the flax-named ``flat`` (strict), applied to
    x [N, T, C] as [N, 1, T, C]: [N, T', C']."""
    torch.nn.ModuleDict({"m": module}).load_state_dict(
        torch_state_from_flax({f"m.{k}": v for k, v in flat.items()}), strict=True)
    with torch.no_grad():
        return module(torch.from_numpy(x)[:, None]).numpy()[:, 0]


def test_diffstg_layout_transforms_against_torch_ops():
    """Each DiffSTG transform against the torch op it converts, applied by
    the port's module: the (3, k) TCN conv + chomp, the (1, T+1)
    down-sampling conv, the stride-1 and stride-2 transposed convs, and
    LayerNorm([1, C])."""
    rng = np.random.default_rng(0)
    N, T, c_in, c_out, k = 3, 12, 4, 6, 3
    x = rng.normal(size=(N, T, c_in)).astype(np.float32)
    conv = torch.nn.Conv2d(c_in, c_out, (3, k), padding=(1, k - 1))
    short = torch.nn.Conv2d(c_in, c_out, (1, 1))
    with torch.no_grad():
        ref = _from4d(conv(_to4d(x))[..., :T] + short(_to4d(x)))
    got = _port_apply(ugnet.TcnBlock(c_in, c_out, k), {
        "Conv_0.kernel": PT._T["conv2d_midrow"](conv.weight.detach().numpy()),
        "Conv_0.bias": conv.bias.detach().numpy(),
        "shortcut.kernel": PT._T["conv2d_1x1"](short.weight.detach().numpy()),
        "shortcut.bias": short.bias.detach().numpy()}, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    T, C, Td = 16, 4, 8
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    conv = torch.nn.Conv2d(C, C, (1, T + 1), padding=(0, Td // 2))
    with torch.no_grad():
        ref = _from4d(conv(_to4d(x)))
    got = _port_apply(ugnet.TimeConv(C, C, T + 1, pad_left=Td // 2, pad_right=Td // 2), {
        "Conv_0.kernel": PT._T["conv2d_midrow"](conv.weight.detach().numpy()),
        "Conv_0.bias": conv.bias.detach().numpy()}, x)
    assert got.shape == ref.shape == (2, Td, C)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    for kk, s, p, TT in ((17, 1, 4, 8), (4, 2, 1, 8)):
        x = rng.normal(size=(2, TT, C)).astype(np.float32)
        convt = torch.nn.ConvTranspose2d(C, C, (1, kk), (1, s), (0, p))
        with torch.no_grad():
            ref = _from4d(convt(_to4d(x)))
        got = _port_apply(ugnet.TimeConvTranspose(C, C, kk, s, p), {
            "kernel": PT._T["convtranspose2d_time"](convt.weight.detach().numpy()),
            "bias": convt.bias.detach().numpy()}, x)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    x = rng.normal(size=(2, 6, C)).astype(np.float32)
    ln = torch.nn.LayerNorm([1, C])
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.normal_()
        ref = ln(torch.from_numpy(x).unsqueeze(2)).squeeze(2).numpy()
        norm = LayerNorm(C, eps=1e-5)
        norm.weight.copy_(torch.from_numpy(PT._T["squeeze_copy"](ln.weight.numpy())))
        norm.bias.copy_(torch.from_numpy(PT._T["squeeze_copy"](ln.bias.numpy())))
        got = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _dts_reference(src):
    key_map = PT.dts_reference_key_map(1, 2)
    sd = _reference_dict(src, key_map)
    sd["model.betas"] = np.linspace(1e-4, 2e-2, 8).astype(np.float32)
    sd["model.alphas_cumprod"] = np.cumprod(1 - sd["model.betas"])
    sd["gt_mask"] = np.ones((24, 2), np.float32)
    sd["scaler_mean"], sd["scaler_std"] = np.zeros(2, np.float32), np.ones(2, np.float32)
    return sd


def test_diffusionts_reference_dict_loads_as_jax_loads_it():
    """A wrapper checkpoint (``model.model.*``, schedule buffers, gt_mask)
    built from the JAX model with its bias-free ``combine_m``: both packages
    convert it alike and the port loads JAX's weights; strict=False takes a
    partial checkpoint without ``combine_m``."""
    jax_model = JDTS(dict(DTS_PARAM))
    src = flatten_params(jax_model.params)
    src["model.combine_m.bias"] = np.zeros_like(src["model.combine_m.bias"])
    sd = _dts_reference(src)
    _assert_same_dict(PT.convert_reference_dts_state_dict(sd, DTS_PARAM),
                      JT.convert_reference_dts_state_dict(sd, DTS_PARAM))
    port = DiffusionTSModel(dict(DTS_PARAM), device="cpu")
    port.load_state_dict(sd)
    _assert_same_dict(_native(port), src)
    partial = {k: v for k, v in sd.items() if "combine_m" not in k}
    got = PT.convert_reference_dts_state_dict(partial, DTS_PARAM, strict=False)
    assert got and not any("combine_m" in k for k in got)
    _assert_same_dict(got, JT.convert_reference_dts_state_dict(partial, DTS_PARAM, strict=False))


# -- losses and scores ---------------------------------------------------------------------

def test_simple_losses_are_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 16)).astype(np.float32)
    p, y = rng.uniform(size=16).astype(np.float32), (rng.uniform(size=16) > 0.5).astype(np.float32)
    logits, labels = rng.normal(size=(8, 3)).astype(np.float32), rng.integers(0, 3, 8)
    for name, args in (("MSELoss", (a, b)), ("BCELoss", (p, y)),
                       ("CrossEntropyLoss", (logits, labels))):
        want = float(JL.train_loss(name)(*map(jnp.asarray, args)))
        got = float(PL.train_loss(name)(*map(torch.as_tensor, args)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), name
    assert float(PL.train_loss("MSELoss")(torch.ones(4), torch.zeros(4))) == 1.0
    with pytest.raises(ValueError, match="define it"):
        PL.train_loss("L1Loss")


def _energy(nx, t):
    return (nx.reshape(nx.shape[0], -1) ** 2).sum(-1) * 0.3 + t * 0.01


@pytest.mark.parametrize("kind", ["GaussianDiffusion", "CategoricalDiffusion",
                                  "DiscreteFlowDiffusion"])
def test_cep_loss_is_jax_on_jax_draws(kind):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(6, 5, 1)).astype(np.float32)
    y = rng.normal(size=6).astype(np.float32)
    params = {"T": 10, "schedule": "cosine"}
    key = jax.random.key(3)
    want = float(JL.CEPLoss(kind, params)(_energy, jnp.asarray(x), jnp.asarray(y), key))
    kt, ks = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (6,), 1, 11))
    eps = np.asarray(jax.random.normal(ks, x.shape, jnp.float32))
    got = float(PL.CEPLoss(kind, params)(_energy, torch.from_numpy(x), torch.from_numpy(y),
                                         t=torch.from_numpy(t), eps=torch.from_numpy(eps)))
    assert got == pytest.approx(want, rel=1e-5)
    tn = t.reshape(6, 1, 1)
    jout = np.asarray(JL.CEPLoss(kind, params).diffusion.sample(jnp.asarray(x), tn, ks))
    pout = PL.CEPLoss(kind, params).diffusion.sample(
        torch.from_numpy(x), torch.from_numpy(tn), eps=torch.from_numpy(eps)).numpy()
    assert pout.shape == jout.shape == x.shape
    np.testing.assert_allclose(pout, jout, rtol=1e-6, atol=1e-7)
    # from the generator: a finite loss that favours the true energies
    cep = PL.CEPLoss(kind, params)
    gen = torch.Generator().manual_seed(0)
    good = float(cep(lambda nx, tt: torch.from_numpy(y), torch.from_numpy(x),
                     torch.from_numpy(y), gen))
    bad = float(cep(lambda nx, tt: torch.zeros(6), torch.from_numpy(x), torch.from_numpy(y),
                    gen))
    assert np.isfinite(good) and good < bad


def test_cep_gaussian_process_in_distribution():
    diff = PL.CEPGaussianDiffusion(8)
    x0 = torch.full((20000, 1), 0.7)
    t = torch.full((20000,), 5, dtype=torch.long)
    out = diff.sample(x0, t[:, None], torch.Generator().manual_seed(0))
    ab = diff.alphabar[5]
    assert abs(out.mean().item() - np.sqrt(ab) * 0.7) < 4 * np.sqrt((1 - ab) / 20000)
    assert abs(out.var().item() / (1 - ab) - 1) < 0.05
    steps = PL.CEPLoss("GaussianDiffusion", {"T": 8})
    seen = []
    steps(lambda nx, tt: seen.append(tt) or tt, torch.zeros(4000, 2), torch.zeros(4000),
          torch.Generator().manual_seed(1))
    assert set(seen[0].long().tolist()) == set(range(1, 9))


def test_evaluation_scores_are_scikit_learns():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 40))
    lab, pred = rng.integers(0, 2, 40), rng.integers(0, 2, 40)
    score = np.round(rng.uniform(size=40), 1)  # ties
    for name, args in (("mse", (a, b)), ("r2", (a, b)), ("r2", (np.ones(5), np.ones(5))),
                       ("r2", (np.ones(5), np.arange(5.0))), ("accuracy", (lab, pred)),
                       ("f1", (lab, pred)), ("f1", (np.zeros(4, int), np.zeros(4, int))),
                       ("roc_auc", (lab, score)), ("kendall_rank", (a, b)),
                       ("rank_accuracy", (a, b)), ("set_correlation", (lab, pred))):
        got, want = PL.evaluation_score(name)(*args), JL.evaluation_score(name)(*args)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), name
    assert PL.evaluation_score("Min_nodes") is None
    with pytest.raises(ValueError, match="Only one class"):
        PL.evaluation_score("roc_auc")(np.ones(4, int), np.arange(4.0))
    with pytest.raises(ValueError, match="don't exit"):
        PL.evaluation_score("nope")


# -- the vanilla loop ----------------------------------------------------------------------

class _TorchNet(torch.nn.Module):
    def __init__(self, f):
        super().__init__()
        self.d0, self.d1 = torch.nn.Linear(2 * f, 8), torch.nn.Linear(8, 1)

    def forward(self, x, adj, t=None):
        h = torch.einsum("bvu,buc->bvc", adj, x)
        h = torch.relu(self.d0(torch.cat([x, h], -1)))
        return self.d1(h.mean(dim=1))


class _TorchEnergy(_TorchNet):
    """One energy per graph, [B], for CEP."""

    def forward(self, x, adj, t=None):
        return super().forward(x, adj)[:, 0]


def _graph_data():
    rng = np.random.default_rng(0)
    n, V = 32, 5
    adj = rng.integers(0, 2, size=(n, V, V)).astype(np.float32)
    adj = ((adj + adj.transpose(0, 2, 1)) > 0).astype(np.float32)
    x = rng.normal(size=(n, V, 2)).astype(np.float32)
    y = adj.sum(axis=(1, 2)) / V
    return ({"x": x[:24], "adj": adj[:24], "y": y[:24]},
            {"x": x[24:], "adj": adj[24:], "y": y[24:]})


def test_vanilla_loop_is_jax_from_the_same_weights(tmp_path):
    from flax import linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, adj):
            h = jnp.einsum("bvu,buc->bvc", adj, x)
            h = nn.relu(nn.Dense(8)(jnp.concatenate([x, h], -1)))
            return nn.Dense(1)(h.mean(axis=1))

    train, val = _graph_data()
    net = Net()
    params = net.init(jax.random.key(7), train["x"][:1], train["adj"][:1])
    tnet = _TorchNet(2)
    with torch.no_grad():
        for mod, name in ((tnet.d0, "Dense_0"), (tnet.d1, "Dense_1")):
            mod.weight.copy_(torch.from_numpy(np.asarray(params["params"][name]["kernel"]).T))
            mod.bias.copy_(torch.from_numpy(np.asarray(params["params"][name]["bias"])))
    tp = {"train_epochs": 8, "batch_size": 8, "score_metrics": ["mse", "r2"]}
    opt = {"optimizer_name": "Adam", "lr": 1e-2}
    from upgdm_tpu.train.vanilla import run_training_vanilla as jax_vanilla

    want = jax_vanilla(train, val, tp, {"task_model": "vanilla"}, {"loss_metric": "MSELoss"},
                       opt, tmp_path / "jax", model_init=lambda k, xx, aa: params,
                       model_apply=lambda p, xx, aa: net.apply(p, xx, aa))
    got = run_training_vanilla(train, val, tp, {"task_model": "vanilla"},
                               {"loss_metric": "MSELoss"}, opt, tmp_path / "port", tnet,
                               device="cpu")
    assert got["epoch"] == want["epoch"] == list(range(8))
    for m in ("mse", "r2"):
        for split in ("train_scores", "val_scores"):
            np.testing.assert_allclose(got[m][split], want[m][split], rtol=1e-4, err_msg=m)
    assert got["mse"]["train_scores"][-1] < got["mse"]["train_scores"][0]
    assert json.loads((tmp_path / "port/record_scores.json").read_text()) == got
    assert (tmp_path / "port/model_trained").exists()


def test_vanilla_loop_cep_and_degree_histogram(tmp_path):
    train, val = _graph_data()
    rs = run_training_vanilla(
        train, val, {"train_epochs": 2, "batch_size": 8, "score_metrics": ["mse", "Min_nodes"]},
        {"task_model": "vanilla"},
        {"loss_metric": "CEPLoss", "diffusion_type": "CategoricalDiffusion",
         "diffusion_params": {"T": 6}},
        {"optimizer_name": "Adam", "lr": 1e-3}, tmp_path,
        _TorchEnergy(2), device="cpu")
    for m in ("mse", "Min_nodes"):
        assert rs[m]["train_scores"] == rs[m]["val_scores"]
        assert np.isfinite(rs[m]["train_scores"]).all()
    from upgdm_tpu.train.vanilla import deg_histogram as jax_deg

    np.testing.assert_array_equal(deg_histogram(train["adj"]), jax_deg(train["adj"]))
    np.testing.assert_array_equal(deg_histogram(np.zeros((0, 3, 3))),
                                  jax_deg(np.zeros((0, 3, 3))))


# -- profiling, plots, exports, imports ----------------------------------------------------

def test_phase_timer_is_jax(tmp_path):
    timers = []
    for mod in (PP, JP):
        pt = mod.PhaseTimer()
        with pt.phase("a"):
            pass
        with pt.phase("a"):
            pass
        with pt.phase("b"):
            pass
        pt.totals.update(a=0.25, b=1.5)  # fixed times: the same report
        timers.append(pt)
    assert timers[0].counts == timers[1].counts == {"a": 2, "b": 1}
    assert timers[0].report() == timers[1].report()
    assert timers[0].as_dict() == timers[1].as_dict()
    timers[0].save(tmp_path / "t" / "phases.json")
    assert json.loads((tmp_path / "t/phases.json").read_text()) == timers[1].as_dict()
    assert PP.phase_timer() is PP.phase_timer()


def test_trace_annotate_and_memory_stats(tmp_path):
    with PP.trace(str(tmp_path / "trace")) as prof:
        with PP.annotate("upgdm_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "upgdm_probe" for e in prof.key_averages())
    assert "upgdm_probe" in (tmp_path / "trace/trace.json").read_text()
    assert PP.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert PP.device_memory_stats() is None


def test_curves_draw_jax_lines():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from upgdm_tpu.utils import data_visualization as JV
    from upgdm_tpu_torch.utils import data_visualization as PV

    rs = {"epoch": [0, 1, 2], "train_scores": [3.0, 2.0, 1.0], "val_scores": [3.5, 2.5, 2.0],
          "mse": {"train_scores": [1, 2, 3], "val_scores": [2, 3, 4]},
          "r2": {"train_scores": [0, .5, .9], "val_scores": [0, .4, .8]}}
    lines = []
    for mod in (PV, JV):
        fig1, fig2 = plt.figure(), plt.figure()
        mod.model_evaluation_metrics_curves(fig1, rs)
        mod.model_evaluation_metrics_curves_vanilla(fig2, rs, ["mse", "r2"])
        lines.append([(ax.get_title(), [l.get_xydata().tolist() for l in ax.lines])
                      for f in (fig1, fig2) for ax in f.axes])
        plt.close(fig1)
        plt.close(fig2)
    assert lines[0] == lines[1]


NEW_MODULES = ("upgdm_tpu_torch.eval.bury", "upgdm_tpu_torch.eval.real_data",
               "upgdm_tpu_torch.figures.real_systems", "upgdm_tpu_torch.utils.h5lite",
               "upgdm_tpu_torch.utils.torch_import", "upgdm_tpu_torch.utils.profiling",
               "upgdm_tpu_torch.utils.data_visualization", "upgdm_tpu_torch.train.losses",
               "upgdm_tpu_torch.train.vanilla")
BANNED = ("jax", "tensorflow", "keras", "h5py", "pandas", "matplotlib", "upgdm_tpu")


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, check=True).stdout.strip().splitlines()


def test_new_modules_import_nothing_of_jax_tensorflow_h5py_pandas_matplotlib():
    out = _run("import importlib, sys\n"
               f"for m in {NEW_MODULES!r}:\n    importlib.import_module(m)\n"
               f"print(sorted(k for k in sys.modules if k.split('.')[0] in {BANNED!r}))")
    assert out[-1] == "[]", out


def test_package_exports_lazily_as_jax_does():
    import upgdm_tpu
    import upgdm_tpu_torch

    out = _run("import sys, upgdm_tpu_torch as p\n"
               "print(sorted(k for k in sys.modules if k.startswith('upgdm_tpu_torch.')))\n"
               "print(p.__version__, sorted(p.__all__))")
    assert out == ["[]", f"{upgdm_tpu.__version__} ['__version__', 'diffusion_models', "
                         "'run_training', 'uncertainty_ews']"]
    model = upgdm_tpu_torch.diffusion_models(task_model="NsDiff", net_param=NET_PARAM,
                                             device="cpu")
    assert isinstance(model, NsDiffModel)
    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.train.loop import run_training

    assert upgdm_tpu_torch.uncertainty_ews.__name__ == uncertainty_ews.__name__
    assert upgdm_tpu_torch.run_training.__name__ == run_training.__name__
