"""The port's training path held against the JAX package (CPU).

Both packages run on the same weights (the port's, drawn from a seed);
batches are made with numpy from a seed; the timesteps, the diffusion noise and TMDM's
reparameterisation draw are the ones the JAX loss draws from its key, handed
to the port through the loss's test seams. Dropout is off (rate 0) unless a
test says otherwise. Covered: the losses of every stage and their gradients
leaf by leaf, the optimizers and their masks over three steps, the four
schedules, dropout, the loop (NaN skip, emergency resume from either
package's file) and checkpoints that flow both ways.
"""
import functools
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
from upgdm_tpu.models.nsdiff import NsDiffVariants as JVariants
from upgdm_tpu.models.tmdm import TMDMModel as JTMDM
from upgdm_tpu.ops import diffusion as JD
from upgdm_tpu.ops.schedules import NsDiffSchedule as JSchedule
from upgdm_tpu.train.optimizers import make_lr_schedule as j_make_lr_schedule
from upgdm_tpu.train.optimizers import make_optimizer as j_make_optimizer
from upgdm_tpu.utils import io as jio
from upgdm_tpu.utils.io import flatten_params, unflatten_params
from upgdm_tpu_torch import diffusion_models
from upgdm_tpu_torch.models.dropout import Dropout
from upgdm_tpu_torch.models.nsdiff import NsDiffModel, NsDiffVariants
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from upgdm_tpu_torch.train.loop import make_train_step, run_training
from upgdm_tpu_torch.train.optimizers import make_lr_schedule, make_optimizer
from upgdm_tpu_torch.utils import io as pio
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "demo_artifacts"

NS = dict(
    dataset_nf=2, windows=16, pred_len=8, rolling_length=4, diffusion_steps=5,
    scaler_type=None, d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
    p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=2, task_model="NsDiff",
    dropout=0.0, sampling_dtype="float32",
)
TM = dict(
    dataset_nf=1, windows=16, pred_len=8, label_len=8, diffusion_steps=4, scaler_type=None,
    d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16, p_hidden_dims=[8, 8],
    p_hidden_layers=2, n_z_samples=2, task_model="TMDM", dropout=0.0, k_z=0.01, k_cond=1.0,
    sampling_dtype="float32",
)
TRAIN = dict(train_model_select="NsDiff_model", train_batch_size=4, val_batch_size=4,
             train_epochs=2, test_set=True, ckpt=False)
ADAM = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5)


def _batch(B, net, seed):
    """[B, windows + pred_len, N]: a random walk around 1."""
    rng = np.random.default_rng(seed)
    L, N = net["windows"] + net["pred_len"], net["dataset_nf"]
    return (rng.normal(size=(B, L, N)) * 0.1).cumsum(axis=1).astype(np.float32) + 1.0


def _data(n, net, seed=0):
    return _batch(n, net, seed)


# -- the JAX side: models, jitted value-and-grad, its draws --------------------
# JAX models are built with their init skipped (its compiles would dominate
# the file): the weights are the port's, drawn once per family from a seed,
# or, for a strict load, zeros in the tree JAX's own init would give
# (shapes by jax.eval_shape of the flax inits, no compile).

def _abstract_params(jm):
    """Zeros in the param tree of ``jm._init_params``."""
    key = jax.random.key(0)
    x = jnp.zeros((1, jm.windows, jm.dataset_nf))
    t = jnp.zeros((1,), jnp.int32)
    if isinstance(jm, JTMDM):
        y = jnp.zeros((1, jm.target_len, jm.dataset_nf))
        parts = {"cond_pred_model": (jm.cond_pred_model, (x,)),
                 "enc_embedding": (jm.enc_embedding, (x,)),
                 "model": (jm.denoiser, (jnp.zeros((1, jm.windows, jm.d_model)), y, y, t))}
    else:
        y = jnp.zeros((1, jm.pred_len, jm.dataset_nf))
        parts = {"cond_pred_model": (jm.cond_pred_model, (x,)),
                 "cond_pred_model_g": (jm.cond_pred_model_g, (x,)),
                 "model": (jm.denoiser, (y, y, y, t))}
    return {name: jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                               jax.eval_shape(mod.init, {"params": key}, *args)["params"])
            for name, (mod, args) in parts.items() if mod is not None}


def jax_model(cls, *args, params=None, **kw):
    """cls(*args, **kw) holding the subtrees of ``params`` it has, or zeros
    in its own tree without ``params``."""

    def init(self):
        if params is None:
            self.params = _abstract_params(self)
            return
        held = {"cond_pred_model": self.cond_pred_model, "model": self.denoiser,
                "cond_pred_model_g": getattr(self, "cond_pred_model_g", None),
                "enc_embedding": getattr(self, "enc_embedding", None)}
        self.params = {k: params[k] for k, mod in held.items() if mod is not None}

    with mock.patch.object(cls, "_init_params", init):
        return cls(*args, **kw)


@functools.lru_cache(maxsize=None)
def _jfull(family):
    """The JAX model of a family with all modules, on the port's seeded weights."""
    port = TMDMModel(TM, seed=1, device="cpu") if family == "TMDM" else NsDiffModel(
        NS, seed=1, device="cpu")
    flat = {k: v for k, v in port.state_dict().items() if not k.startswith("scaler_")}
    params = jax.tree.map(jnp.asarray, unflatten_params(flat))
    return jax_model(JTMDM, TM, params=params) if family == "TMDM" else jax_model(
        JNsDiff, NS, params=params)


def _jax(cls, *args, **kw):
    """cls(*args, **kw) on the weights of _jfull."""
    return jax_model(cls, *args, params=_jfull("TMDM" if cls is JTMDM else "NsDiff").params,
                     **kw)


@functools.lru_cache(maxsize=None)
def _jmodel(stage):
    if stage in ("Guassian", "cond_mean", "cond_var", "wo_UANS"):
        return _jax(JVariants, NS, stage)
    return _jfull("TMDM" if stage.startswith("TMDM") else "NsDiff")


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(stage, select, train):
    jm = _jmodel(stage)
    return jax.jit(jax.value_and_grad(
        lambda p, b, k: jm.loss_fn(p, b, k, select=select, train=train)))


def _port_for(stage):
    """The port model of a stage; a pretrain stage holds only its module."""
    if stage in ("pretrain_f", "pretrain_g"):
        port = NsDiffModel(NS, train_model_select=stage, device="cpu")
        top = "cond_pred_model" if stage == "pretrain_f" else "cond_pred_model_g"
        port.load_state_dict({k: v for k, v in _jmodel(stage).state_dict().items()
                              if k.split(".")[0] == top}, strict=True)
        return port
    if stage in ("Guassian", "cond_mean", "cond_var", "wo_UANS"):
        port = NsDiffVariants(NS, stage, device="cpu")
    elif stage.startswith("TMDM"):
        port = TMDMModel(TM, device="cpu")
    else:
        port = NsDiffModel(NS, device="cpu")
    port.load_state_dict(_jmodel(stage).state_dict(), strict=True)
    return port


def _nsdiff_draws(key, n, shape, T):
    """The t and e NsDiffModel.loss_fn draws from key (nsdiff.py:196-220)."""
    _, kt, ke = jax.random.split(key, 3)
    t = JNsDiff.antithetic_t(kt, n, T)
    return np.array(t), np.array(jax.random.normal(ke, shape, jnp.float32))


def _tmdm_draws(jm, params, batch, key, train):
    """t, noise and the averaged reparameterisation normal of
    TMDMModel.loss_fn (tmdm.py:131-141); the normal is backed out of the
    z_sample flax returns, in float64."""
    kd, kr, kt, ke = jax.random.split(key, 4)
    n = batch.shape[0]
    shape = (n, jm.label_len + jm.pred_len, batch.shape[-1])
    t = np.array(jm.antithetic_t(kt, n, jm.sched.num_timesteps))
    noise = np.array(jax.random.normal(ke, shape, jnp.float32))
    if not train:
        return t, noise, None
    (_, _, _, z), inter = _jvae_capture(jm)(params["cond_pred_model"],
                                            jnp.asarray(batch[:, : jm.windows]), kd, kr)
    z_mean = np.asarray(inter["z_mean_1"]["__call__"][0], np.float64)
    z_logvar = np.asarray(inter["z_logvar_1"]["__call__"][0], np.float64)
    eps = (np.asarray(z, np.float64) - z_mean) / np.sqrt(np.exp(z_logvar))
    return t, noise, eps.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jvae_capture(jm):
    """The VAE's outputs and intermediates in the loss's training mode."""

    def run(p, x, kd, kr):
        out, state = jm.cond_pred_model.apply(
            {"params": p}, x, deterministic=False, rngs={"dropout": kd, "reparam": kr},
            capture_intermediates=True, mutable=["intermediates"])
        return out, state["intermediates"]

    return jax.jit(run)


def _port_seams(stage, jm, params, batch, key, train):
    if stage.startswith("TMDM"):
        t, noise, eps = _tmdm_draws(jm, params, batch, key, train)
        return dict(t=t, noise=noise, reparam_eps=None if eps is None else torch.from_numpy(eps))
    if stage in ("pretrain_f", "pretrain_g"):
        return {}
    t, e = _nsdiff_draws(key, batch.shape[0], (batch.shape[0], NS["pred_len"], NS["dataset_nf"]),
                         NS["diffusion_steps"])
    return dict(t=t, noise=e)


def _grads(port):
    return flax_flat_from_torch({
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in port.net.named_parameters()})


STAGES = ["pretrain_f", "pretrain_g", "NsDiff_model", "Guassian", "cond_mean", "cond_var",
          "wo_UANS", "TMDM", "TMDM_eval"]


@functools.lru_cache(maxsize=None)
def _loss_and_grads(stage):
    """(port loss, port grads, JAX loss, JAX grads) on one batch and key."""
    train = stage != "TMDM_eval"
    net = TM if stage.startswith("TMDM") else NS
    jm = _jmodel(stage)
    select = stage if stage in ("pretrain_f", "pretrain_g") else None
    batch = _batch(6, net, seed=STAGES.index(stage))
    key = jax.random.key(7)
    jkey = "NsDiff_model" if select else stage  # one compile per (model, select)
    jl, jg = _jvalue_and_grad(jkey, select, train)(jm.params, jnp.asarray(batch), key)
    port = _port_for(stage)
    loss = port.loss_fn(torch.from_numpy(batch), select=select, train=train,
                        **_port_seams(stage, jm, jm.params, batch, key, train))
    loss.backward()
    # a pretrain stage's JAX gradient is zero outside the stage's module
    jg = flatten_params(jax.device_get(jg))
    held = {k.split(".")[0] for k in port.state_dict()}
    assert all(not np.asarray(v).any() for k, v in jg.items() if k.split(".")[0] not in held)
    return (loss.item(), _grads(port), float(jl),
            {k: v for k, v in jg.items() if k.split(".")[0] in held})


@pytest.mark.parametrize("stage", STAGES)
def test_loss_matches_jax(stage):
    got, _, want, _ = _loss_and_grads(stage)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stage", STAGES)
def test_gradients_match_jax_leaf_by_leaf(stage):
    """Each leaf within 1e-4 of that leaf's largest JAX gradient. The
    attention key biases have a zero gradient in exact arithmetic (a shift
    shared by a query's scores leaves the softmax unchanged): only rounding
    is left in them, held below 1e-6 of the model's largest gradient on
    both sides."""
    _, got, _, want = _loss_and_grads(stage)
    assert set(got) == set(want)
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k in want:
        w = np.asarray(want[k])
        if k.endswith(".key.bias"):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * top, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


def test_nsdiff_forward_terms_match_jax():
    rng = np.random.default_rng(3)
    shape = (5, 8, 2)
    y, y0, gx, ys, z = (rng.uniform(0.1, 1.5, size=shape).astype(np.float32) for _ in range(5))
    t = rng.integers(0, 20, size=5)
    js, ps = JSchedule.create("linear", 20), NsDiffSchedule.create("linear", 20)
    jc = JD.nsdiff_gather(js, jnp.asarray(t), jnp.asarray(y))
    pc = D.nsdiff_gather(ps, torch.as_tensor(t), torch.from_numpy(y))
    T = torch.from_numpy
    for name, want, got in (
            ("forward_noise", JD.nsdiff_forward_noise(jc, gx, ys),
             D.nsdiff_forward_noise(pc, T(gx), T(ys))),
            ("sigma_tilde", JD.nsdiff_sigma_tilde(jc, gx, ys),
             D.nsdiff_sigma_tilde(pc, T(gx), T(ys))),
            ("q_sample", JD.nsdiff_q_sample(y, y0, js, jnp.asarray(t), z),
             D.nsdiff_q_sample(T(y), T(y0), ps, torch.as_tensor(t), T(z)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("n", [5, 6])
def test_antithetic_t(n):
    port = NsDiffModel(NS, device="cpu")
    t = port.antithetic_t(n, 20, torch.Generator().manual_seed(0)).numpy()
    half = n // 2 + 1
    assert t.shape == (n,) and t.min() >= 0 and t.max() < 20
    np.testing.assert_array_equal(t[half:], 19 - t[: n - half])


# -- optimizers and schedules -----------------------------------------------

# Adam at lr 1e-4: its update g / (sqrt(v) + 1e-8) turns a gradient element
# near 1e-8, whose low digits are rounding on either side, into up to lr of
# a step; at 1e-3 such elements of g(x)'s 512 x 512 kernel moved by 4e-6 in
# three steps, over the 1e-6 bar.
OPTIMIZERS = {
    "adam_wd": dict(optimizer_name="Adam", lr=1e-4, weight_decay=1e-2),
    "sgd_momentum": dict(optimizer_name="SGD", lr=1e-2, momentum=0.9, weight_decay=1e-3),
}


@pytest.mark.parametrize("opt,mask", [("adam_wd", "freeze_pretrain"), ("adam_wd", "pretrain_g"),
                                      ("sgd_momentum", "pretrain_f"), ("sgd_momentum", "all")])
def test_three_optimizer_steps_match_optax(opt, mask):
    """Three steps on the full NsDiff model: frozen leaves stay bit-equal,
    the rest agree within 1e-6 abs / 1e-5 rel."""
    net = dict(NS, freeze_pretrain=mask == "freeze_pretrain")
    select = mask if mask.startswith("pretrain") else None
    jm = _jax(JNsDiff, net)
    jmask = jm.trainable_mask(select)
    tx = j_make_optimizer(OPTIMIZERS[opt], trainable_mask=jmask)
    params, state = jm.params, tx.init(jm.params)
    vg = _jvalue_and_grad("NsDiff_model", select, True)

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    port = NsDiffModel(net, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    start = port.state_dict()
    pmask = port.trainable_mask(select)
    assert pmask == jmask
    popt = make_optimizer(OPTIMIZERS[opt], port.net, pmask)
    for i in range(3):
        batch = _batch(6, NS, seed=20 + i)
        key = jax.random.key(30 + i)
        _, g = vg(params, jnp.asarray(batch), key)
        params, state = update(g, state, params)
        popt.zero_grad()
        port.loss_fn(torch.from_numpy(batch), select=select, train=True,
                     **_port_seams("NsDiff_model", jm, jm.params, batch, key, True)).backward()
        popt.step()
    got, want = port.state_dict(), flatten_params(jax.device_get(params))
    for k, w in want.items():
        if not pmask[k.split(".")[0]]:
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
            np.testing.assert_array_equal(w, start[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    frozen = [n for n, on in pmask.items() if not on]
    assert all(not p.requires_grad for n in frozen for p in port.net[n].parameters())
    in_opt = {id(p) for g in popt.param_groups for p in g["params"]}
    assert all(id(p) not in in_opt for n in frozen for p in port.net[n].parameters())


SCHEDULES = {
    "StepLR": dict(scheduler="StepLR", stepLR_stepsize=3, stepLR_gamma=0.5),
    "MultiStepLR": dict(scheduler="MultiStepLR", MstepLR_milestones=[2, 5], MstepLR_gamma=0.3),
    "CosineAnnealingLR": dict(scheduler="CosineAnnealingLR", CALR_Tmax=6, CALR_minlr=1e-4),
    "CyclicLR": dict(scheduler="CyclicLR", CyclicLR_blr=1e-4, CyclicLR_mlr=1e-3,
                     CyclicLR_upsteps=4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """Epochs 0 .. 3 T_max: cosine holds at eta_min after T_max."""
    param = dict(lr="1e-3", scheduler_set=True, **SCHEDULES[name])
    want, got = j_make_lr_schedule(param), make_lr_schedule(param)
    t_max = 6
    for epoch in range(3 * t_max + 1):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=1e-6, err_msg=str(epoch))
    if name == "CosineAnnealingLR":
        assert got(t_max) == got(3 * t_max) == pytest.approx(1e-4)
    assert make_lr_schedule(dict(param, scheduler_set=False)) is None


# -- dropout --------------------------------------------------------------------

def test_dropout_module():
    x = torch.ones(4000)
    assert Dropout(0.5)(x) is x and Dropout(0.0)(x, torch.Generator()) is x
    y = Dropout(0.5)(x, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < (y == 0).float().mean().item() < 0.55
    assert torch.equal(y, Dropout(0.5)(x, torch.Generator().manual_seed(0)))
    assert not Dropout(1.0)(x, torch.Generator()).any()
    with pytest.raises(ValueError):
        Dropout(1.5)


@pytest.mark.parametrize("family", ["NsDiff", "TMDM"])
def test_dropout_is_active_only_in_training(family):
    """train=True differs from train=False at rate 0.3 and equals it at
    rate 0 (same t, noise and, for TMDM, z = z_mean)."""
    net = NS if family == "NsDiff" else TM
    batch = torch.from_numpy(_batch(4, net, seed=5))
    seams = dict(t=np.array([0, 3, 1, 2]), noise=np.zeros((4, 8 if family == "NsDiff" else 16,
                                                           net["dataset_nf"]), np.float32))
    if family == "TMDM":
        seams["reparam_eps"] = torch.zeros(4, 16, 16)
    losses = {}
    for rate in (0.0, 0.3):
        m = diffusion_models(family, dict(net, dropout=rate), device="cpu")
        for train in (True, False):
            losses[rate, train] = m.loss_fn(batch, train=train, **seams).item()
    assert losses[0.0, True] == losses[0.0, False] == losses[0.3, False]
    assert losses[0.3, True] != losses[0.3, False]


def test_seeded_runs_give_identical_records(tmp_path):
    data = _data(12, NS)
    net = dict(NS, dropout=0.1)
    runs = [run_training(data[:8], data[8:], TRAIN, net, {}, ADAM, tmp_path / f"r{i}",
                         seed=s, device="cpu") for i, s in enumerate((3, 3, 4))]
    assert runs[0] == runs[1]
    assert runs[0]["train_scores"] != runs[2]["train_scores"]
    saved = json.loads((tmp_path / "r0/train_trace/record_scores.json").read_text())
    assert saved == runs[0]


# -- the loop -----------------------------------------------------------------------

def _nan_on(model, calls):
    """Make the training loss NaN on the given call numbers (1-based)."""
    loss_fn, count = model.loss_fn, [0]

    def wrapped(batch, select=None, train=True, **kw):
        out = loss_fn(batch, select=select, train=train, **kw)
        if train:
            count[0] += 1
            if count[0] in calls:
                out = out * float("nan")
        return out

    model.loss_fn = wrapped
    return count


def test_nan_loss_leaves_weights_and_optimizer_state_untouched():
    model = NsDiffModel(NS, device="cpu")
    opt = make_optimizer(dict(ADAM, lr=0.1), model.net, model.trainable_mask())
    step = make_train_step(model, opt, None, lr_at=lambda n: 0.1 * 0.5 ** n)
    _nan_on(model, {2})
    batch = torch.from_numpy(_batch(4, NS, seed=1))
    assert np.isfinite(step(batch))
    before = model.state_dict()
    moments = {k: v.clone() for k, v in opt.state[next(iter(opt.state))].items()}
    assert np.isnan(step(batch))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    for k, v in opt.state[next(iter(opt.state))].items():
        assert torch.equal(v, moments[k]), k
    assert opt.param_groups[0]["applied_updates"] == 1
    assert np.isfinite(step(batch))  # the schedule saw one applied update
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)
    assert opt.param_groups[0]["applied_updates"] == 2


def test_run_training_skips_nan_batches_in_the_running_mean(tmp_path):
    data = _data(12, NS)
    model = NsDiffModel(NS, device="cpu")
    _nan_on(model, {1})
    rs = run_training(data[:8], data[8:], dict(TRAIN, train_epochs=1), NS, {}, ADAM, tmp_path,
                      model=model)
    assert rs["epoch"] == [0] and np.isfinite(rs["train_scores"][0])
    assert not (tmp_path / "emergency_checkpoint.pth").exists()


def test_nan_at_epoch_end_writes_the_emergency_checkpoint_and_resumes(tmp_path, capsys):
    """Epoch 1 ends on a NaN: the emergency file holds epoch 0's record,
    step 1 and the torch optimizer state; the final checkpoint is written
    anyway; a second run resumes at epoch 1 with the saved moments."""
    data = _data(12, NS)
    model = NsDiffModel(NS, device="cpu")
    _nan_on(model, {4})  # 2 batches an epoch: the last batch of epoch 1
    train = dict(TRAIN, train_epochs=3, ckpt=True, ckpt_period=1)
    rs = run_training(data[:8], data[8:], train, NS, {}, ADAM, tmp_path, model=model)
    assert "training interrupted: loss is None" in capsys.readouterr().out
    assert rs["epoch"] == [0]
    step, record, sd, opt_state = pio.load_emergency_checkpoint(tmp_path)
    assert step == 1 and record["epoch"] == [0] and opt_state is not None
    ck = pio.load_pt(tmp_path / "emergency_checkpoint.pth")
    assert "mdoel_params" in ck and "optimizer_state_bytes" not in ck
    assert (tmp_path / "trained_model/model_trained").exists()
    assert (tmp_path / "trained_model/model_trained.yaml").exists()
    rs = run_training(data[:8], data[8:], train, NS, {}, ADAM, tmp_path, device="cpu")
    assert "fresh optimizer moments" not in capsys.readouterr().out
    assert rs["epoch"] == [0, 1, 2] and all(np.isfinite(rs["train_scores"]))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "tmpt_model_1iter", "tmpt_model_2iter"]


def test_resume_from_a_jax_emergency_file(tmp_path, capsys):
    """JAX wrote flax optimizer bytes: the port resumes the weights, the
    epoch and the records with fresh moments, and says so."""
    jm = _jfull("NsDiff")
    tx = j_make_optimizer(ADAM, jm.trainable_mask())
    record = {"epoch": [0, 1, 2], "train_scores": [9.0, 8.0, 7.0], "val_scores": [9.0, 8.0, 7.0]}
    jio.emergency_checkpoint(tmp_path, jm.state_dict(), NS,
                             serialization.to_bytes(tx.init(jm.params)), step=3,
                             record_scores=record)
    data = _data(12, NS)
    rs = run_training(data[:8], data[8:], dict(TRAIN, train_epochs=3), NS, {}, ADAM, tmp_path,
                      device="cpu")
    out = capsys.readouterr().out
    assert out.count("fresh optimizer moments") == 1 and "epoch 3" in out
    assert rs == record
    _, sd = pio.load_checkpoint(tmp_path / "trained_model/model_trained")
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)
    rs = run_training(data[:8], data[8:], dict(TRAIN, train_epochs=5), NS, {}, ADAM, tmp_path,
                      device="cpu")
    assert rs["epoch"] == [0, 1, 2, 3, 4] and rs["train_scores"][:3] == [9.0, 8.0, 7.0]
    assert all(np.isfinite(rs["train_scores"][3:]))


def test_train_dtype_bfloat16(tmp_path):
    """bf16 products with float32 master weights: the step's loss is near
    the float32 loss on the same draws and the weights stay float32."""
    batch = torch.from_numpy(_batch(4, NS, seed=6))
    losses = {}
    for dt in ("float32", "bfloat16"):
        m = NsDiffModel(dict(NS, train_dtype=dt), device="cpu")
        opt = make_optimizer(ADAM, m.net, m.trainable_mask())
        m.generator.manual_seed(0)
        losses[dt] = make_train_step(m, opt, None)(batch)
        assert all(p.dtype == torch.float32 for p in m.net.parameters())
        assert all(s.dtype == torch.float32 for st in opt.state.values() for s in st.values())
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=5e-2)
    with pytest.raises(ValueError, match="train_dtype"):
        make_train_step(NsDiffModel(dict(NS, train_dtype="fp16"), device="cpu"), opt, None)
    with pytest.raises(NotImplementedError):
        run_training(_data(4, NS), _data(4, NS), TRAIN, NS, {}, ADAM, tmp_path,
                     adj=np.eye(2), device="cpu")


def test_bf16_sampling_after_training_uses_the_new_weights(tmp_path):
    """The cast copies of fg_sampling_dtype="bfloat16" are dropped when
    run_training changes the weights."""
    net = dict(NS, fg_sampling_dtype="bfloat16")
    model = NsDiffModel(net, device="cpu")
    x = _batch(3, NS, seed=8)[:, : NS["windows"]]
    before = model.f_and_g(x)[0]
    run_training(_data(8, NS), _data(4, NS), TRAIN, net, {}, dict(ADAM, lr=1e-2), tmp_path,
                 model=model)
    fresh = NsDiffModel(net, device="cpu")
    fresh.load_state_dict(pio.load_checkpoint(tmp_path / "trained_model/model_trained")[1])
    after = model.f_and_g(x)[0]
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh.f_and_g(x)[0])


# -- checkpoints both ways ----------------------------------------------------------

def test_three_stage_protocol_checkpoints_load_into_jax(tmp_path):
    """pretrain_f -> pretrain_g -> NsDiff_model (load_pretrain, load_pretrain_f)
    in the port; the JAX model built on the same paths takes the same g and
    f, and loads the final checkpoint strictly with f(x) within 2e-5."""
    data = _data(12, NS)
    paths = {}
    for stage in ("pretrain_f", "pretrain_g"):
        paths[stage] = tmp_path / stage
        run_training(data[:8], data[8:], dict(TRAIN, train_model_select=stage), NS, {}, ADAM,
                     paths[stage], device="cpu")
        (paths[stage] / "model_trained").write_bytes(
            (paths[stage] / "trained_model/model_trained").read_bytes())
    net = dict(NS, load_pretrain=True, load_pretrain_f=True,
               pretrain_f_path=str(paths["pretrain_f"]), pretrain_g_path=str(paths["pretrain_g"]))
    model = diffusion_models("NsDiff", net, train_model_select="NsDiff_model", device="cpu")
    jm = _jax(JNsDiff, net, pretrain_f_path=net["pretrain_f_path"],
              pretrain_g_path=net["pretrain_g_path"])
    jsd, psd = jm.state_dict(), model.state_dict()
    for k in jsd:
        if not k.startswith("model."):
            np.testing.assert_array_equal(psd[k], np.asarray(jsd[k]), err_msg=k)
    run_training(data[:8], data[8:], TRAIN, net, {}, ADAM, tmp_path / "main", model=model)
    net_param, sd = jio.load_checkpoint(tmp_path / "main/trained_model/model_trained")
    back = jax_model(JNsDiff, net_param)
    back.load_state_dict(sd, strict=True)
    x = data[:3, : NS["windows"]]
    want = jax.jit(lambda p, b: back._apply_f(p, b))(back.params, jnp.asarray(x))
    with torch.no_grad():
        got = model._apply_f(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_jax_trained_checkpoints_keep_training_in_the_port(tmp_path):
    """The demo's JAX pretrain_g checkpoint loads through load_pretrain and
    its final NsDiff checkpoint strictly; the port trains on from it and
    JAX loads the result strictly."""
    cfg = pio.read_model_config(DEMO / "nsdiff/trained_model")
    net = dict(cfg["net"], pretrain_g_path=str(DEMO / "pre_model_G"))
    model = diffusion_models("NsDiff", net, train_model_select="NsDiff_model", device="cpu")
    _, g_sd = jio.load_checkpoint(DEMO / "pre_model_G/model_trained")
    psd = model.state_dict()
    for k, v in g_sd.items():
        if k.startswith("cond_pred_model_g."):
            np.testing.assert_array_equal(psd[k], v, err_msg=k)
    _, sd = jio.load_checkpoint(DEMO / "nsdiff/trained_model/model_trained")
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).normal(size=(8, 200, 2)).astype(np.float32)
    rs = run_training(x[:4], x[4:], dict(TRAIN, train_epochs=1), net, {}, ADAM, tmp_path,
                      model=model)
    assert np.isfinite(rs["train_scores"][0])
    net_param, out = jio.load_checkpoint(tmp_path / "trained_model/model_trained")
    assert any(not np.array_equal(out[k], sd[k]) for k in sd if k.startswith("model."))
    jax_model(JNsDiff, net_param).load_state_dict(out, strict=True)


def test_training_surface_and_factory():
    batch = _batch(4, NS, seed=9)
    full = NsDiffModel(NS, device="cpu")
    for fn in (full.training_step, full.pretrain_f, full.pretrain_g):
        v = fn(batch)
        assert v.ndim == 0 and torch.isfinite(v) and not v.requires_grad
    assert torch.isfinite(TMDMModel(TM, device="cpu").training_step(_batch(4, TM, seed=9)))
    var = diffusion_models("NsDiff_model_variants", NS, train_model_select="cond_var",
                           device="cpu")
    assert isinstance(var, NsDiffVariants) and set(var.net) == {"cond_pred_model_g", "model"}
    assert var.trainable_mask("pretrain_f") == {"cond_pred_model_g": True, "model": True}
    with pytest.raises(ValueError, match="Guassian"):
        NsDiffVariants(NS, "NsDiff_model", device="cpu")
    freeze = NsDiffModel(dict(NS, freeze_pretrain=True), device="cpu")
    assert freeze.trainable_mask() == {"cond_pred_model": False, "cond_pred_model_g": False,
                                       "model": True}
