"""The port's multi-device layer (``upgdm_tpu_torch/parallel``) on the CPU.

Groups of 2 and 4 gloo processes hold the data-parallel step, both sharded
sweeps and ``run_training``'s ``dataparallel`` flag to one process at the
JAX package's own 1-vs-N bars (``tests/test_cli_and_parallel.py``), with
dropout on; at 2 ranks they are also held to the JAX package's
``make_dp_train_step`` and ``sharded_fast_mpv_sweep`` on its 8-device virtual
mesh, on JAX's draws. Each world size's group is spawned once for the
module and runs a battery of checks (``_battery``) whose results come back
through files; a group that outlives its deadline is killed and fails.

JAX is imported inside the functions that use it: the spawned ranks and the
grid search's pool import this module and need none of it.
"""
import datetime
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from upgdm_tpu_torch.cli.train_driver import grid_search, parallel_grid_search
from upgdm_tpu_torch.eval.uncertainty import batched_window_ensemble, fast_mpv_sweep
from upgdm_tpu_torch.models.diffstg import DiffSTGModel
from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel
from upgdm_tpu_torch.models.dropout import Dropout
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.parallel import draws
from upgdm_tpu_torch.parallel import mesh as M
from upgdm_tpu_torch.parallel.data_parallel import (
    dp_train_epoch, make_dp_train_step, sharded_fast_mpv_sweep, sharded_window_ensemble,
)
from upgdm_tpu_torch.parallel.dryrun import dryrun_multigpu, entry
from upgdm_tpu_torch.train import loop as train_loop
from upgdm_tpu_torch.train.loop import make_train_step, run_training
from upgdm_tpu_torch.train.optimizers import make_optimizer
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the tiny configurations of tests/test_cli_and_parallel.py, dropout on
NS = dict(dataset_nf=1, windows=16, pred_len=8, rolling_length=4, diffusion_steps=5,
          scaler_type=None, d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
          p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=4, task_model="NsDiff",
          dropout=0.1, sampling_dtype="float32")
TM = dict(NS, task_model="TMDM", label_len=8, n_reparam_samples=10)
DTS = dict(dataset_nf=1, windows=16, pred_len=8, diffusion_steps=4, timesteps=8, d_model=16,
           n_heads=2, n_layer_enc=1, n_layer_dec=2, n_z_samples=2, scaler_type=None,
           task_model="DiffusionTS", attn_pd=0.1, resid_pd=0.1, sampling_dtype="float32")
V = 6
STG = dict(T_h=8, T_p=8, F=1, diffusion_steps=10, inference_diffusion_steps=3,
           inference_trick="ddim", inference_schedule="cosine", diffusion_schedule="linear",
           scaler_type=None, d_h=4, Td_h=6, channel_multipliers=[1, 2], n_blocks=1,
           gnn_name="GCNConv", parallel_sampling=2, sequential_sampling=1, mask_ratio=0.1,
           init_num_nodes=V, task_model="DiffSTG")
SGD = dict(optimizer_name="SGD", lr=1e-3, momentum=0.9, weight_decay=0.0)
B, STEPS, CHUNK_WINDOWS, N_WINDOWS = 16, 4, 2, 9
WORLDS = (2, 4)
DEADLINE_S = 120.0
# the JAX package's 1-vs-N bars (tests/test_cli_and_parallel.py:278-283, 320, 413-414)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-7
MPV_RTOL, MEAN_ATOL = 2e-5, 1e-6


def _batch(n, net, seed):
    """[n, windows + pred_len, N]: a random walk around 1."""
    rng = np.random.default_rng(seed)
    L = net["windows"] + net["pred_len"]
    return ((rng.normal(size=(n, L, 1)) * 0.1).cumsum(axis=1) + 1.0).astype(np.float32)


def _graph_batch(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, V, STG["T_h"] + STG["T_p"], 1)) * 0.1).cumsum(axis=2)
    return x.astype(np.float32)


def _windows(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_WINDOWS, 2, 16, 1)) * 0.1 + 1.0).astype(np.float32)


# -- the cases a group runs, and one process runs as the reference ----------------
DP_CASES = {  # name: (model, train_model_select)
    "pretrain_f": (lambda: NsDiffModel(NS, "pretrain_f", seed=7, device="cpu"), "pretrain_f"),
    "pretrain_g": (lambda: NsDiffModel(NS, "pretrain_g", seed=7, device="cpu"), "pretrain_g"),
    "NsDiff_model": (lambda: NsDiffModel(NS, seed=7, device="cpu"), None),
    "TMDM": (lambda: TMDMModel(TM, seed=7, device="cpu"), None),
    "DiffusionTS": (lambda: DiffusionTSModel(DTS, seed=7, device="cpu"), None),
}
SWEEP_MODELS = {"NsDiff": (NsDiffModel, NS), "TMDM": (TMDMModel, TM)}


def _grads(model):
    return {k: np.array(v) for k, v in flax_flat_from_torch(
        {n: p.grad for n, p in model.net.named_parameters() if p.grad is not None}).items()}


def _dp_case(name, mesh):
    """(losses of STEPS data-parallel SGD-momentum steps, the gradients of
    the first, the weights after the last) on one global batch."""
    build, select = DP_CASES[name]
    model = build()
    step = make_dp_train_step(model, make_optimizer(SGD, model.net, model.trainable_mask(select)),
                              mesh, select=select)
    batch = _batch(B, DTS if name == "DiffusionTS" else NS, seed=len(name))
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(step(batch))
        grads = grads or _grads(model)
    return losses, grads, model.state_dict()


def _sweep_model(family):
    cls, net = SWEEP_MODELS[family]
    model = cls(dict(net, scaler_type="StandardScaler"), seed=3, device="cpu")
    model.scaler_fit(_windows(seed=2).reshape(-1, 1))
    model.generator.manual_seed(50)
    return model


def _train_run(path, mesh_world, adj=False):
    """run_training with the flag (every batch a multiple of 4 rows: no tail
    to trim at 2 or 4 ranks), SGD with momentum; a graph model on its
    shared adjacency. ``mesh_world`` None is the plain 1-process run."""
    train = dict(train_model_select="NsDiff_model", train_batch_size=8, val_batch_size=4,
                 train_epochs=2, test_set=True, ckpt=False)
    if mesh_world is not None:
        train["dataparallel"] = True
    if adj:
        data = _graph_batch(20, seed=5)
        return run_training(data[:16], data[16:], train, STG, {}, SGD, path,
                            adj=np.ones((V, V), np.float32), seed=4, device="cpu")
    data = _batch(20, NS, seed=5)
    return run_training(data[:16], data[16:], train, NS, {}, SGD, path, seed=4, device="cpu")


def _battery(rank, world, tmp, jax_inputs):
    """Everything a rank of a ``world``-rank gloo group checks."""
    torch.set_num_threads(1)
    mesh = M.make_mesh(world)
    out = {"dp": {name: _dp_case(name, mesh) for name in DP_CASES}, "sweep": {}}
    for family in SWEEP_MODELS:
        out["sweep"][family] = sharded_fast_mpv_sweep(
            _sweep_model(family), _windows(), NS["pred_len"], mesh, CHUNK_WINDOWS)
    out["ensemble"] = sharded_window_ensemble(_sweep_model("NsDiff"), _windows(),
                                              NS["pred_len"], mesh, CHUNK_WINDOWS)
    out["train"] = _train_run(Path(tmp) / f"flat_rank{rank}", world)
    out["train_adj"] = _train_run(Path(tmp) / f"adj_rank{rank}", world, adj=True)
    if jax_inputs is not None:
        out["jax"] = _jax_battery(mesh, jax_inputs)
    return out


def _jax_battery(mesh, inp):
    """The port's side of (6): one SGD step on JAX's weights and draws, and
    the sweep on JAX's normals."""
    model = NsDiffModel(inp["net"], seed=0, device="cpu")
    model.load_state_dict(inp["state"])
    t, e = torch.as_tensor(inp["t"]), torch.as_tensor(inp["e"])
    loss_fn = model.loss_fn
    model.loss_fn = lambda b, **kw: loss_fn(b, t=draws.keep_rows(t), noise=draws.keep_rows(e),
                                            **kw)
    opt = make_optimizer(dict(optimizer_name="SGD", lr=1.0), model.net, model.trainable_mask())
    loss = make_dp_train_step(model, opt, mesh)(inp["batch"])
    sweeper = NsDiffModel(inp["net"], seed=0, device="cpu")
    sweeper.load_state_dict(inp["sweep_state"])
    mpv = sharded_fast_mpv_sweep(sweeper, inp["windows"], inp["net"]["pred_len"], mesh,
                                 inp["chunk_windows"], noise=inp["noise"])
    return {"loss": loss, "grads": _grads(model), "mpv": mpv}


# -- the JAX side of (6), computed before the 2-rank group starts -----------------
def _jax_normals(key, S, T, shape):
    """The normals JAX's nsdiff_p_sample_loop draws for each of the S sample
    keys (tests/test_torch_port_slice.py)."""
    import jax
    import jax.numpy as jnp

    def draws_of(k):
        k, k0 = jax.random.split(k)
        z_T = jax.random.normal(k0, shape, jnp.float32)
        ks = jax.random.split(k, T - 1)
        return z_T, jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float32))(ks)

    z_T, zs = jax.vmap(draws_of)(jax.random.split(key, S))
    zs = np.array(zs)
    return [np.array(z_T)] + [zs[:, i] for i in range(T - 1)]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's make_dp_train_step and sharded_fast_mpv_sweep on a 2-device
    mesh, and what the port's ranks need to repeat them on JAX's draws."""
    import jax
    import jax.numpy as jnp

    from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
    from upgdm_tpu.parallel import data_parallel as JDP
    from upgdm_tpu.parallel import mesh as JM
    from upgdm_tpu.train.optimizers import make_optimizer as j_make_optimizer
    from upgdm_tpu.utils.io import flatten_params

    net = dict(NS, dropout=0.0)
    jm = JNsDiff(net)
    state = jm.state_dict()
    mesh = JM.make_mesh(2)
    batch = _batch(B, NS, seed=11)
    key = jax.random.key(5)
    _, kt, ke = jax.random.split(key, 3)
    t = np.array(JNsDiff.antithetic_t(kt, B, net["diffusion_steps"]))
    e = np.array(jax.random.normal(ke, (B, net["pred_len"], 1), jnp.float32))
    sharded = jax.device_put(jnp.asarray(batch), JM.dp_sharding(mesh))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b, key, train=True)),
                      in_shardings=(JM.replicated(mesh), JM.dp_sharding(mesh)),
                      out_shardings=JM.replicated(mesh))
    _, grads = grad_fn(jm.params, sharded)
    grads = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(grads)).items()}
    tx = j_make_optimizer({"optimizer_name": "SGD", "lr": 1.0}, jm.trainable_mask())
    params = jax.tree.map(jnp.array, jm.params)  # the step donates its input
    _, _, loss = JDP.make_dp_train_step(jm, tx, mesh)(params, tx.init(params), sharded, key)

    sweeper = JNsDiff(dict(net, scaler_type="StandardScaler"), seed=2)
    sweeper.scaler_fit(_windows(seed=2).reshape(-1, 1))
    wins, cw = _windows(seed=3), CHUNK_WINDOWS
    sweeper._rng_counter = 20
    want = JDP.sharded_fast_mpv_sweep(sweeper, wins, net["pred_len"], mesh=mesh,
                                      chunk_windows=cw)
    rows = 2 * cw * wins.shape[1]
    noise = [_jax_normals(jax.random.fold_in(sweeper._root_key, 20 + b), net["n_z_samples"],
                          net["diffusion_steps"], (rows, net["pred_len"], 1))
             for b in range(1, -(-len(wins) // (2 * cw)) + 1)]
    inputs = dict(net=dict(net, scaler_type="StandardScaler"), state=state, batch=batch, t=t, e=e,
                  sweep_state=sweeper.state_dict(), windows=wins, chunk_windows=cw, noise=noise)
    return inputs, {"loss": float(loss), "grads": grads,
                    "mpv": tuple(np.asarray(a) for a in want)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory, jax_side):
    """``groups(world)`` -> (every rank's battery results, the run
    directory): each world size's group spawned once for the module."""
    runs = {}

    def get(world):
        if world not in runs:
            tmp = tmp_path_factory.mktemp(f"ranks{world}")
            runs[world] = M.spawn_ranks(
                _battery, world, (world, str(tmp), jax_side[0] if world == 2 else None),
                deadline_s=DEADLINE_S), tmp
        return runs[world]

    return get


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_on_every_rank(results, key):
    for r, res in enumerate(results[1:], 1):
        assert _equal(res[key], results[0][key]), f"{key}: rank {r} differs from rank 0"
    return results[0][key]


# -- (1) maybe_init_distributed ------------------------------------------------------
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")


@pytest.fixture
def fake_init(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(M, "_DISTRIBUTED_INITIALIZED", False)
    calls = []
    monkeypatch.setattr(M.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_maybe_init_distributed_is_noop_single_process(fake_init, monkeypatch):
    """No arguments and no torchrun variables: nothing happens. Explicit
    arguments route through exactly once; a rank and world size without an
    address still opt in (tests/test_cli_and_parallel.py:185-228)."""
    assert M.maybe_init_distributed(device="cpu") is False
    assert fake_init == []
    assert M.maybe_init_distributed("file:///tmp/x", 2, 0, device="cpu") is True
    assert fake_init == [dict(backend="gloo", init_method="file:///tmp/x", world_size=2,
                              rank=0)]
    assert M.maybe_init_distributed("file:///tmp/x", 2, 0, device="cpu") is False
    assert len(fake_init) == 1
    monkeypatch.setattr(M, "_DISTRIBUTED_INITIALIZED", False)
    fake_init.clear()
    assert M.maybe_init_distributed(world_size=4, rank=2, device="cpu") is True
    assert fake_init == [dict(backend="gloo", init_method=None, world_size=4, rank=2)]


def test_maybe_init_distributed_reads_torchrun(fake_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29123")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    timeout = datetime.timedelta(seconds=5)
    assert M.maybe_init_distributed(device="cpu", timeout=timeout) is True
    assert fake_init == [dict(backend="gloo", init_method="tcp://localhost:29123",
                              world_size=2, rank=1, timeout=timeout)]


def test_maybe_init_distributed_backend_by_device(fake_init, monkeypatch):
    """gloo on the CPU, NCCL on CUDA with the rank's card set; more NCCL
    ranks than cards raise; the card is the default and raises without one."""
    cards = []
    monkeypatch.setattr(M.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(M.torch.cuda, "set_device", cards.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert M.maybe_init_distributed("file:///tmp/y", 2, 1) is True
    assert fake_init[-1]["backend"] == "nccl" and cards == [1]
    monkeypatch.setattr(M, "_DISTRIBUTED_INITIALIZED", False)
    with pytest.raises(RuntimeError, match="one rank per card"):
        M.maybe_init_distributed("file:///tmp/y", 4, 3, device="cuda")
    monkeypatch.setattr(M.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.maybe_init_distributed("file:///tmp/y", 2, 0)
    assert len(fake_init) == 1


def test_mesh_without_a_group():
    mesh = M.make_mesh()
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    x = torch.arange(6.0)
    assert mesh.all_reduce_mean(x) is x and mesh.all_gather(x) is x
    assert M.dp_sharding(mesh, 6) == slice(0, 6) and M.replicated(mesh, x) is x
    with pytest.raises(RuntimeError, match="torchrun"):
        M.make_mesh(2)
    with pytest.raises(ValueError):
        M.dp_sharding(M.Mesh(4, 1, torch.device("cpu")), 6)
    assert M.dp_sharding(M.Mesh(4, 1, torch.device("cpu")), 8) == slice(2, 4)


# -- (2) the rule for draws, site by site -----------------------------------------
LO, HI, TOTAL = 2, 4, 6  # rank 1 of 3


def _nsdiff_chain(rows):
    m = NsDiffModel(NS, device="cpu")
    y0 = torch.linspace(0.5, 1.5, TOTAL * 8).reshape(TOTAL, 8, 1)[rows]
    return lambda g: m.sample_chain(y0, y0 * 0.1 + 0.01, g)


def _tmdm_chain(rows):
    m = TMDMModel(TM, device="cpu")
    x = torch.as_tensor(_batch(TOTAL, TM, seed=3)[:, :16])[rows]
    y0, emb = m.cond_fn(x)
    return lambda g: m.sample_chain(y0, emb, g)


def _loss(build, net, rows, **kw):
    m = build()
    b = torch.as_tensor(_batch(TOTAL, net, seed=4))[rows]
    return lambda g: m.loss_fn(b, generator=g, **kw)


def _dts_sampler(rows):
    m = DiffusionTSModel(DTS, device="cpu")
    x = torch.as_tensor(_batch(TOTAL, DTS, seed=4)[:, :16])[rows]
    return lambda g: m.sample_fn(x, g)


def _stg_loss(rows):
    m = DiffSTGModel(STG, device="cpu")
    b = torch.as_tensor(_graph_batch(TOTAL, seed=6))[rows]
    return lambda g: m.loss_fn(b, torch.ones(V, V), generator=g)


def _dropout(rows):
    x = torch.ones(TOTAL, 3, 5)[rows]
    return lambda g: Dropout(0.5)(x, g)


def _antithetic(rows):
    m = NsDiffModel(NS, device="cpu")
    n = len(range(TOTAL)[rows])
    return lambda g: m.antithetic_t(n, 20, g)


DRAW_SITES = {
    "dropout_mask": _dropout,
    "antithetic_t": _antithetic,
    "nsdiff_sampler_normals": _nsdiff_chain,
    "tmdm_sampler_normals": _tmdm_chain,
    "nsdiff_loss": lambda r: _loss(lambda: NsDiffModel(NS, device="cpu"), NS, r),
    "tmdm_loss_and_reparam": lambda r: _loss(lambda: TMDMModel(TM, device="cpu"), TM, r),
    "diffusionts_loss": lambda r: _loss(lambda: DiffusionTSModel(DTS, device="cpu"), DTS, r),
    "diffusionts_sampler": _dts_sampler,
    "diffstg_loss": _stg_loss,
}


@pytest.mark.parametrize("site", sorted(DRAW_SITES))
def test_row_shard_draws_the_global_rows(site, monkeypatch):
    """Every draw a site makes under ``row_shard(lo, hi, total)`` equals the
    one-process draw of the global batch cut to rows lo:hi on its batch
    axis, in the same order; the generators end in the same state."""
    seen = []
    plain_draw = draws.draw

    def spy(fn, shape, batch_axis=0):
        out = plain_draw(fn, shape, batch_axis)
        seen.append((out.clone(), batch_axis))
        return out

    monkeypatch.setattr(draws, "draw", spy)
    runs = {}
    for name, rows in (("global", slice(None)), ("rank", slice(LO, HI))):
        seen.clear()
        gen = torch.Generator().manual_seed(9)
        fn = DRAW_SITES[site](rows)
        if name == "rank":
            with draws.row_shard(LO, HI, TOTAL):
                fn(gen)
        else:
            fn(gen)
        runs[name] = (list(seen), gen.get_state())
    (glob, g_state), (local, l_state) = runs["global"], runs["rank"]
    assert len(glob) == len(local) > 0
    for (g, axis), (l, _) in zip(glob, local):
        k = g.shape[axis] // TOTAL
        assert torch.equal(g.narrow(axis, LO * k, (HI - LO) * k), l)
    assert torch.equal(g_state, l_state)


def test_draws_outside_a_row_shard_are_the_plain_calls():
    for fn, plain in ((lambda g: draws.randn((3, 4, 2), g, batch_axis=1),
                       lambda g: torch.randn((3, 4, 2), generator=g)),
                      (lambda g: draws.rand((5,), g), lambda g: torch.rand((5,), generator=g)),
                      (lambda g: draws.randint(0, 9, (7,), g),
                       lambda g: torch.randint(0, 9, (7,), generator=g))):
        a, b = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        assert torch.equal(fn(a), plain(b))
    z = torch.arange(12.0).reshape(6, 2)
    assert draws.keep_rows(z) is z
    with draws.row_shard(LO, HI, TOTAL):
        assert torch.equal(draws.keep_rows(z), z[LO:HI])
        with pytest.raises(ValueError, match="row shard"):
            draws.randn((5, 2))
    assert draws.randn((5, 2)).shape == (5, 2)  # the shard ended with its block


# -- (3)-(7) against one process ----------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_matches_one_process(groups, world):
    """Losses of four SGD-momentum steps rtol 1e-5, the weights after them
    rtol 1e-5 / atol 1e-6, the first step's gradients rtol 2e-5 / atol 1e-7
    (tests/test_cli_and_parallel.py:278-283, 320), dropout on, for NsDiff's
    three stages, TMDM and DiffusionTS. JAX's gradient bar is for gradients
    of unit scale: its absolute term is taken relative to the model's largest
    gradient where that exceeds 1 (DiffusionTS's reach ~36, and float32 sums
    terms of that size to ~1e-7 of it, on ranks' shards as on the batch)."""
    results, _ = groups(world)
    dp = _same_on_every_rank(results, "dp")
    for name in DP_CASES:
        losses, grads, params = _dp_case(name, M.make_mesh())
        got_l, got_g, got_p = dp[name]
        np.testing.assert_allclose(got_l, losses, rtol=LOSS_RTOL, err_msg=name)
        assert set(got_g) == set(grads) and set(got_p) == set(params)
        top = max(1.0, max(np.abs(g).max() for g in grads.values()))
        for k in grads:
            np.testing.assert_allclose(got_g[k], grads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL * top,
                                       err_msg=f"{name} {k}")
        for k in params:
            np.testing.assert_allclose(got_p[k], params[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", sorted(SWEEP_MODELS))
def test_sharded_fast_mpv_sweep_matches_one_process(groups, world, family):
    """At chunk = ranks x chunk_windows, with a ragged last block: MPV rtol
    2e-5, means atol 1e-6 (tests/test_cli_and_parallel.py:413-414)."""
    results, _ = groups(world)
    mpv, pm = _same_on_every_rank(results, "sweep")[family]
    want_mpv, want_pm = fast_mpv_sweep(_sweep_model(family), _windows(), NS["pred_len"],
                                       chunk_windows=world * CHUNK_WINDOWS, device="cpu")
    assert mpv.shape == pm.shape == (N_WINDOWS,)
    assert N_WINDOWS % (world * CHUNK_WINDOWS)
    np.testing.assert_allclose(mpv, want_mpv, rtol=MPV_RTOL)
    np.testing.assert_allclose(pm, want_pm, rtol=MPV_RTOL, atol=MEAN_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_window_ensemble_matches_one_process(groups, world):
    results, _ = groups(world)
    got = _same_on_every_rank(results, "ensemble")
    want = batched_window_ensemble(_sweep_model("NsDiff"), _windows(), NS["pred_len"],
                                   chunk_windows=world * CHUNK_WINDOWS, device="cpu")
    assert len(got) == len(want) == N_WINDOWS
    for g, w in zip(got, want):
        assert g.shape == (2, NS["pred_len"], 1, NS["n_z_samples"])
        np.testing.assert_allclose(g, w, rtol=MPV_RTOL, atol=MEAN_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_run_training_with_the_flag_matches_one_process(groups, world, tmp_path):
    """The records of a flat model at rtol 1e-5 of the 1-process run, and a
    graph model's (the plain step on every rank) equal; only rank 0 writes."""
    results, tmp = groups(world)
    got = _same_on_every_rank(results, "train")
    want = _train_run(tmp_path / "flat", None)
    assert got["epoch"] == want["epoch"]
    for key in ("train_scores", "val_scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
    assert _same_on_every_rank(results, "train_adj") == _train_run(tmp_path / "adj", None,
                                                                   adj=True)
    rel = "train_trace/record_scores.json"
    for kind in ("flat", "adj"):
        assert json.loads((tmp / f"{kind}_rank0" / rel).read_text()) == results[0][
            "train" if kind == "flat" else "train_adj"]
        assert (tmp / f"{kind}_rank0/trained_model/model_trained.yaml").exists()
        assert not any((tmp / f"{kind}_rank{r}").exists() for r in range(1, world))


# -- (6) against JAX on its virtual mesh ----------------------------------------------
def test_dp_step_and_sweep_match_jax_on_jax_draws(groups, jax_side):
    """At 2 ranks, on JAX's t and noise (dropout 0): the loss rtol 1e-5 /
    atol 1e-6 and each gradient leaf within 1e-4 of its largest JAX value
    (the plain step's bars, tests/test_torch_port_train.py); the sweep on
    JAX's normals rtol 1e-4 / atol 1e-5 (tests/test_torch_port_slice.py)."""
    results, _ = groups(2)
    got = _same_on_every_rank(results, "jax")
    _, want = jax_side
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    assert set(got["grads"]) == set(want["grads"])
    top = max(np.abs(w).max() for w in want["grads"].values())
    for k, w in want["grads"].items():
        if k.endswith(".key.bias"):  # zero in exact arithmetic: rounding only
            assert max(np.abs(w).max(), np.abs(got["grads"][k]).max()) <= 1e-6 * top, k
        else:
            np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
    for g, w in zip(got["mpv"], want["mpv"]):
        assert g.shape == w.shape == (N_WINDOWS,)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# -- (7) the trim rule and JAX's kept behaviours, in one process ------------------------
def test_dataparallel_batches_drop_their_ragged_tail(tmp_path, monkeypatch):
    """Each shuffled batch is cut to a multiple of the world size and a batch
    with nothing left is skipped (upgdm_tpu/train/loop.py:235-241)."""
    fake = M.Mesh(2, 0, torch.device("cpu"))
    monkeypatch.setattr(train_loop, "data_parallel_mesh", lambda train_param, device: fake)
    seen = []

    def recording_step(model, optimizer, mesh, select=None, lr_at=None):
        assert mesh is fake
        return lambda batch: seen.append(len(batch)) or 1.0

    import upgdm_tpu_torch.parallel.data_parallel as dp_mod
    monkeypatch.setattr(dp_mod, "make_dp_train_step", recording_step)
    data = _batch(11, NS, seed=0)
    train = dict(train_model_select="NsDiff_model", train_batch_size=4, val_batch_size=4,
                 train_epochs=2, test_set=False, ckpt=False, dataparallel=True)
    run_training(data[:7], data[7:], train, NS, {}, SGD, tmp_path / "a", device="cpu")
    assert seen == [4, 2] * 2
    seen.clear()
    rs = run_training(data[:3], data[7:], dict(train, train_batch_size=1), NS, {}, SGD,
                      tmp_path / "b", device="cpu")
    assert seen == [] and rs["train_scores"] == [0.0, 0.0]


def test_dp_step_keeps_jax_behaviour():
    """JAX's data-parallel step calls the loss directly: it ignores
    ``train_dtype`` and applies a NaN loss (no finite guard), where the
    plain step casts and skips (ROADMAP Queue C, kept by design)."""
    batch = _batch(4, NS, seed=2)
    losses = {}
    for name, dt, maker in (("plain32", "float32", make_train_step),
                            ("plain16", "bfloat16", make_train_step),
                            ("dp16", "bfloat16", None)):
        m = NsDiffModel(dict(NS, train_dtype=dt), seed=1, device="cpu")
        opt = make_optimizer(SGD, m.net, m.trainable_mask())
        step = maker(m, opt, None) if maker else make_dp_train_step(m, opt, M.make_mesh())
        losses[name] = step(batch)
    assert losses["dp16"] == losses["plain32"] != losses["plain16"]

    bad = batch.copy()
    bad[0, 0, 0] = np.nan
    for maker, applied in ((make_train_step, 0), (None, 1)):
        m = NsDiffModel(NS, seed=1, device="cpu")
        opt = make_optimizer(SGD, m.net, m.trainable_mask())
        step = maker(m, opt, None) if maker else make_dp_train_step(m, opt, M.make_mesh())
        assert np.isnan(step(bad))
        assert opt.param_groups[0]["applied_updates"] == applied
        finite = all(torch.isfinite(p).all() for p in m.net.parameters())
        assert finite == (applied == 0)


def test_dp_train_epoch_batches_in_order_and_drops_the_tail():
    """Batches of max(batch_size // n * n, n) rows in order, the tail dropped,
    the mean loss; on one rank each is the data-parallel step's."""
    data = _batch(10, NS, seed=8)
    losses = {}
    for name in ("epoch", "steps"):
        m = NsDiffModel(NS, seed=2, device="cpu")
        opt = make_optimizer(SGD, m.net, m.trainable_mask())
        if name == "epoch":
            losses[name] = dp_train_epoch(m, opt, M.make_mesh(), data, 4)
        else:
            step = make_dp_train_step(m, opt, M.make_mesh())
            losses[name] = float(np.mean([step(data[0:4]), step(data[4:8])]))
    assert losses["epoch"] == losses["steps"]


def test_entry_gives_the_tiny_nsdiff_loss():
    fn, args = entry("cpu")
    loss = fn(*args)
    assert loss.shape == () and torch.isfinite(loss)


# -- (8) the process-parallel grid search ----------------------------------------------
def grid_dataset(dataset_param):
    """The grid's dataset (module level: the pool's processes import it)."""
    return _batch(12, NS, seed=dataset_param["seed"]), None, 1


GRID = dict(
    dataset={"windows": [16], "pred_len": [8], "sampling_t": [1], "seed": [3]},
    train={"train_model_select": ["NsDiff_model"], "train_batch_size": [4],
           "val_batch_size": [4], "train_epochs": [2], "test_set": [True], "ckpt": [False],
           "traindata_size": [0.75], "model_evaluation": ["hold_out"]},
    net={k: [v] for k, v in NS.items()},
    loss={"loss_metric": ["KL divergence"]},
    optimizer={"optimizer_name": ["Adam"], "lr": [1e-3, 5e-4]},
)


def test_parallel_grid_search_matches_grid_search(tmp_path, monkeypatch):
    """Two configurations in two spawned processes: each one's records equal
    the sequential grid search's (the same seed per configuration)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the pool's processes, as this one
    sections = [GRID[k] for k in ("dataset", "train", "net", "loss", "optimizer")]
    got = parallel_grid_search(*sections, tmp_path / "par", grid_dataset, processes=2,
                               device="cpu")
    grid_search(*sections, tmp_path / "seq", grid_dataset, hp_analysis_root=tmp_path / "hp",
                device="cpu")
    want = json.loads(next((tmp_path / "seq").rglob("configs_record_scores.json")).read_text())
    assert sorted(got) == ["config_0", "config_1"] and got == want
    rel = "hold_out/train_trace/record_scores.json"
    for name, rs in got.items():
        assert json.loads((tmp_path / "par/grid_search" / name / rel).read_text()) == rs


# -- (9) the dry run ----------------------------------------------------------------
def test_dryrun_multigpu_two_gloo_ranks(capsys):
    first = dryrun_multigpu(2, device="cpu", deadline_s=DEADLINE_S)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.match(r"dryrun_multigpu OK on 2 ranks \(gloo\); loss=\S+ diffstg_loss=\S+ "
                    r"tmdm_loss=\S+ diffusionts_loss=\S+ bench_geometry_windows=6$", line), line
    assert first["mpv"].shape == (6,) and np.isfinite(first["mpv"]).all()


def test_spawn_ranks_fails_with_a_failing_rank():
    with pytest.raises(Exception, match="rank 1 fails"):
        M.spawn_ranks(_fail_on_rank_one, 2, deadline_s=DEADLINE_S)


def _fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(DEADLINE_S)  # killed with the group when rank 1 fails
