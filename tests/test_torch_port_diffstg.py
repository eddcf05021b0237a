"""The port's DiffSTG slice held against the JAX package (CPU): the loss and
its gradients, the DDIM/DDPM sampler, bf16 sampling, training through the
``adj`` path and the spdata CLI, checkpoints both ways, the cache runner and
the DiffSTG branch of ``uncertainty_ews``.

Both packages run on the same weights (the port's, drawn from a seed); the
JAX models skip their init (its compile would dominate the file) and hold
those weights. The timesteps, normals and mask draws are the ones JAX draws
from its keys, handed to the port through the test seams of ``loss_fn`` and
``sample_fn``, so what is compared is the arithmetic, float32 on both sides.
Sizes: V 6-8, T_h = T_p = 8, d_h 4, Td_h 4, S 4, 5 inference steps.
"""
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from upgdm_tpu.cli import train_spdata as jax_train_spdata
from upgdm_tpu.eval import uncertainty as JU
from upgdm_tpu.models.diffstg import DiffSTGModel as JDiffSTG
from upgdm_tpu.utils import io as jio
from upgdm_tpu.utils.io import flatten_params, unflatten_params
from upgdm_tpu_torch.cli import train_spdata
from upgdm_tpu_torch.eval import uncertainty as PU
from upgdm_tpu_torch.models.diffstg import DiffSTGModel
from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
from upgdm_tpu_torch.ops.schedules import diffstg_schedule
from upgdm_tpu_torch.train.loop import run_training
from upgdm_tpu_torch.utils import io as pio
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


V = 6
NET = dict(
    T_h=8, T_p=8, F=1, d_h=4, Td_h=4, channel_multipliers=[1, 2], n_blocks=1,
    gnn_name="ResGatedGraphConv", gnn_param={"bias": True, "root_weight": True},
    diffusion_steps=50, diffusion_schedule="linear", inference_diffusion_steps=5,
    inference_trick="ddim", inference_schedule="cosine", loss_weight_schedule="constant",
    parallel_sampling=2, sequential_sampling=2, mask_ratio=0.3, scaler_type=None,
    task_model="DiffSTG", sampling_dtype="float32",
)
# the JAX package's bars: a sampled chain against its plain twin
# (tests/test_torch_parity.py) and two sampling dtypes (tests/test_models_e2e.py:171)
SAMPLE_RTOL, SAMPLE_ATOL, MPV_REL = 2e-4, 2e-5, 0.01


def _graph(rng, n=V, pad=0):
    a = (rng.uniform(size=(n, n)) < 0.5).astype(np.float32)
    a = ((a + a.T) > 0).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    return np.pad(a, ((0, pad), (0, pad)))


def _graphml(path, adj):
    """A .graphml of a 0/1 adjacency, in networkx's layout."""
    n = adj.shape[0]
    nodes = "".join(f'<node id="{i}"/>' for i in range(n))
    edges = "".join(f'<edge source="{i}" target="{j}"/>'
                    for i in range(n) for j in range(i + 1, n) if adj[i, j])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('<?xml version="1.0" encoding="utf-8"?><graphml '
                    'xmlns="http://graphml.graphdrawing.org/xmlns"><graph '
                    f'edgedefault="undirected">{nodes}{edges}</graph></graphml>')


def jax_model(net, flat):
    """JAX's DiffSTGModel(net) holding the flat weights ``flat``, or zeros in
    the tree of its own init with ``flat`` None (shapes by jax.eval_shape:
    no init compile); its key counter stands where its init leaves it."""

    def init(self, n):
        if flat is None:
            x, t, adj = jnp.zeros((1, n, self.T, self.F)), jnp.zeros((1,)), jnp.zeros((1, n, n))
            shapes = jax.eval_shape(self.net.init, jax.random.key(0), x, t, x, adj)
            self.params = {"model": jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                                 shapes["params"])}
        else:
            self.params = jax.tree.map(jnp.asarray, unflatten_params(dict(flat)))
        self.next_key()

    with mock.patch.object(JDiffSTG, "_init_params", init):
        return JDiffSTG(net)


def _weights(port):
    return {k: v for k, v in port.state_dict().items() if not k.startswith("scaler")}


# ------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("weight", ["constant", "logNormal"])
def test_loss_and_gradients_match_jax(weight):
    """The training loss on a padded batch with JAX's t, noise and history
    mask draws, with ``node_mask`` and without (every node counts): loss at
    rtol 1e-5, every gradient leaf within 1e-4 of its largest |jax.grad|
    (the bar of tests/test_torch_port_train.py)."""
    net = dict(NET, loss_weight_schedule=weight)
    port = DiffSTGModel(net, seed=1, device="cpu")
    jm = jax_model(net, _weights(port))
    rng = np.random.default_rng(4)
    B, Vp = 3, V + 2
    batch = rng.normal(size=(B, Vp, 16, 1)).astype(np.float32)
    batch[:, V:] = 0.0
    adj = np.stack([_graph(rng, V, 2) for _ in range(B)])
    mask = np.zeros((B, Vp), bool)
    mask[:, :V] = True
    key = jax.random.key(5)

    def vg(p, node_mask):
        return jax.value_and_grad(lambda q: jm.loss_fn(
            q, batch, adj, key, node_mask=node_mask, train=True))(p)

    wants = jax.jit(lambda p: (vg(p, mask), vg(p, None)))(jm.params)
    _, km, kt, ke = jax.random.split(key, 4)
    draws = dict(mask_draw=np.asarray(jax.random.uniform(km, (B, Vp, 8, 1))),
                 t=np.asarray(jax.random.randint(kt, (B,), 1, 51)),
                 noise=np.asarray(jax.random.normal(ke, batch.shape)))
    losses = []
    for node_mask, (loss_j, grads_j) in zip((mask, None), wants):
        port.net.zero_grad(set_to_none=True)
        loss = port.loss_fn(batch, adj, node_mask=node_mask, **draws)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
        got = flax_flat_from_torch({n: p.grad for n, p in port.net.named_parameters()})
        want = flatten_params(grads_j)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        losses.append(loss.item())
    assert losses[0] != losses[1]  # the padded nodes count without the mask


def test_q_sample_and_posterior_step():
    rng = np.random.default_rng(0)
    sched = diffstg_schedule(30, "quad")
    x0 = torch.from_numpy(rng.normal(size=(2, 3, 4, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=x0.shape).astype(np.float32))
    t = torch.tensor([1, 30])
    xt = D.diffstg_q_sample(x0, sched, t, eps)
    ab = torch.tensor(sched.alphabar, dtype=torch.float32)[t].reshape(2, 1, 1, 1)
    torch.testing.assert_close(xt, ab.sqrt() * x0 + (1 - ab).sqrt() * eps)
    # DDIM at target 0 recovers x0 from the exact eps; DDPM at t = 1 adds no z
    x = D.diffstg_q_sample(x0[:1], sched, 10, eps[:1])
    back = D.diffstg_posterior_step(sched, x, eps[:1], 10, 0, "ddim")
    torch.testing.assert_close(back, x0[:1], rtol=1e-5, atol=1e-5)
    x1 = D.diffstg_q_sample(x0[:1], sched, 1, eps[:1])
    one = D.diffstg_posterior_step(sched, x1, eps[:1], 1, 0, "ddpm", z=torch.ones_like(x1))
    torch.testing.assert_close(one, x0[:1], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        D.diffstg_posterior_step(sched, x, eps[:1], 10, 5, "euler")


# ---------------------------------------------------------------- sampling
def _jax_draws(key, S, shape, steps):
    """The normals of JAX's sample_fn for ``key``: x_T [S, *shape] and the
    z of every step [steps, S, *shape]."""
    x0s, zs = [], []
    for k in jax.random.split(key, S):
        k, k0 = jax.random.split(k)
        x0s.append(np.asarray(jax.random.normal(k0, (1,) + shape))[0])
        zs.append([np.asarray(jax.random.normal(kz, (1,) + shape))[0]
                   for kz in jax.random.split(k, steps)])
    return np.stack(x0s), np.stack([np.stack(z) for z in zip(*zs)])


@pytest.mark.parametrize("trick", ["ddim", "ddpm"])
def test_sample_fn_matches_jax_on_its_draws(trick):
    """S = 4 members over 5 cosine steps on JAX's normals: every sample at
    rtol 2e-4 / atol 2e-5, output [V, T, F, S]; the step table folds the
    float64 schedule as JAX's does."""
    net = dict(NET, inference_trick=trick)
    port = DiffSTGModel(net, seed=2, device="cpu")
    jm = jax_model(net, _weights(port))
    rng = np.random.default_rng(6)
    hist = rng.normal(size=(V, 8, 1)).astype(np.float32)
    adj = _graph(rng)
    key = jax.random.key(8)
    want = np.asarray(jax.jit(lambda p: jm.sample_fn(p, hist, adj, key, 4))(jm.params))
    got = port.sample_fn(hist, adj, n_samples=4,
                         noise=_jax_draws(key, 4, (V, 16, 1), 5)).numpy()
    assert got.shape == want.shape == (V, 16, 1, 4)
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    # the port's own generator: a different, finite ensemble of the same shape
    own = port.sample_fn(hist, adj, n_samples=4).numpy()
    assert own.shape == got.shape and np.isfinite(own).all()


def test_bf16_default_mpv_within_1pct_of_float32():
    """The default sampling dtype is bf16 (UGnet weights and inputs; the
    chain, the coefficients and the draws float32): on the same draws its
    ensemble MPV is within 1% of float32's, and its samples differ."""
    net = {k: v for k, v in NET.items() if k != "sampling_dtype"}
    m16 = DiffSTGModel(net, seed=3, device="cpu")
    m32 = DiffSTGModel(dict(net, sampling_dtype="float32"), seed=3, device="cpu")
    assert m16.sampling_dtype() == torch.bfloat16
    rng = np.random.default_rng(7)
    hist = rng.normal(size=(12, 8, 1)).astype(np.float32)
    adj = _graph(rng, 12)
    S = 64
    draws = (rng.normal(size=(S, 12, 16, 1)).astype(np.float32),
             rng.normal(size=(5, S, 12, 16, 1)).astype(np.float32))
    e16 = m16.sample_fn(hist, adj, n_samples=S, noise=draws).numpy()
    e32 = m32.sample_fn(hist, adj, n_samples=S, noise=draws).numpy()
    mpv16, mpv32 = e16.var(axis=-1).mean(), e32.var(axis=-1).mean()
    assert abs(mpv16 - mpv32) / mpv32 < MPV_REL
    assert np.abs(e16 - e32).max() > 0


# ---------------------------------------------------------------- training
TRAIN = dict(train_model_select=None, train_batch_size=4, val_batch_size=4, train_epochs=2,
             test_set=True, ckpt=False)
ADAM = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5)


def test_run_training_adj_paths(tmp_path):
    """The spdata CLI's bundle is the JAX package's ``(adjs, graph_ids)``,
    and the loop hands DiffSTG's loss the batch's adjacencies and no node
    mask: on a padded batch of that corpus the loss the loop takes equals
    JAX's (unmasked) loss on the same draws, rtol 1e-5. One adjacency for
    every window goes through too, and bf16 training casts the adjacency
    with the batch. Records finite, a checkpoint with the yaml."""
    _write_spdata(tmp_path, np.random.default_rng(1))
    dataset_param = dict(spdata_file_path=str(tmp_path / "spdata"),
                         graph_file_path=str(tmp_path / "graphs"), filter="*",
                         sampling_t=0.1, windows=8, pred_len=8, interval_step=40)
    x, bundle, nf = train_spdata.build_dataset(dataset_param)
    jx, jbundle, jnf = jax_train_spdata.build_dataset(dataset_param)
    assert nf == jnf == 1 and len(bundle) == len(jbundle) == 2
    for got, want in zip((x,) + bundle, (jx,) + jbundle):
        np.testing.assert_array_equal(got, want)
    adjs, gids = bundle
    Vp, n = adjs.shape[1], len(x)
    assert Vp == V + 2 and not x[gids == 0][:, V:].any()  # the 6-node graph, padded
    net = dict(NET, scaler_type="StandardScaler")
    seen = []
    orig = DiffSTGModel.loss_fn

    def spy(self, batch, adj, **kw):
        seen.append((batch.clone(), adj.clone(), sorted(kw)))
        return orig(self, batch, adj, **kw)

    tr, va = np.arange(n - 4), np.arange(n - 4, n)
    with mock.patch.object(DiffSTGModel, "loss_fn", spy):
        for i, adj in enumerate((adjs[1], (adjs, gids[tr], gids[va]))):
            seen.clear()
            rs = run_training(x[tr], x[va], TRAIN, net, {}, ADAM, tmp_path / str(i), adj=adj,
                              device="cpu")
            assert np.isfinite(rs["train_scores"]).all() and len(rs["val_scores"]) == 2
            assert all(a.shape == (len(b), Vp, Vp) for b, a, _ in seen)
            assert all("node_mask" not in kw for _, _, kw in seen)
        rs = run_training(x[tr], x[va], TRAIN, dict(net, train_dtype="bfloat16"), {}, ADAM,
                          tmp_path / "bf16", adj=(adjs, gids[tr], gids[va]), device="cpu")
    assert np.isfinite(rs["train_scores"]).all()
    # a batch of the mixed run that holds a padded window: JAX's loss on it
    batch, adj = next((b, a) for b, a, _ in seen if (a[:, V:].sum(dim=(1, 2)) == 0).any())
    batch, adj = batch.numpy(), adj.numpy()
    port = DiffSTGModel(net, seed=1, device="cpu")
    jm = jax_model(net, _weights(port))
    B = len(batch)
    key = jax.random.key(3)
    loss = jax.jit(lambda p, m: jm.loss_fn(p, batch, adj, key, node_mask=m, train=False))
    want = float(loss(jm.params, None))
    _, km, kt, ke = jax.random.split(key, 4)
    got = port.loss_fn(batch, adj, train=False,
                       mask_draw=np.asarray(jax.random.uniform(km, (B, Vp, 8, 1))),
                       t=np.asarray(jax.random.randint(kt, (B,), 1, 51)),
                       noise=np.asarray(jax.random.normal(ke, batch.shape))).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the padded nodes count: JAX's masked loss is another number
    real = np.ones((B, Vp), bool)
    real[adj[:, V:].sum(axis=(1, 2)) == 0, V:] = False
    assert abs(float(loss(jm.params, real)) - want) > 1e-6 * abs(want)
    cfg = yaml.safe_load((tmp_path / "1/trained_model/model_trained.yaml").read_text())
    assert cfg["net"]["task_model"] == "DiffSTG"
    net_param, sd = pio.load_checkpoint(tmp_path / "1/trained_model/model_trained")
    assert "scaler_mean" in sd and "model.out_time_kernel" in sd


def _write_spdata(root, rng, T=200):
    """<root>/spdata/<g>/rec.pt on two graphs of 6 and 8 nodes, with their
    .graphml files under <root>/graphs."""
    for name, n in (("ga", V), ("gb", V + 2)):
        _graphml(root / "graphs" / f"{name}.graphml", _graph(rng, n))
        ys = (rng.normal(size=(T, n)) * 0.05).cumsum(axis=0).astype(np.float32) + 0.5
        pio.save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(T, dtype=np.float32) * 0.1,
                     "tp_values": np.zeros(T, np.float32)}, root / "spdata" / name / "rec.pt")


def test_train_spdata_hold_out_checkpoint_loads_into_jax(tmp_path):
    """``cli.train_spdata --train_mode hold_out --device cpu`` on two padded
    graphs: its checkpoint loads strictly into the JAX package's DiffSTG,
    whose loss on JAX's draws equals the port's."""
    _write_spdata(tmp_path, np.random.default_rng(2))
    cfg = {
        "out_dir": str(tmp_path / "out"),
        "dataset": {"spdata_file_path": [str(tmp_path / "spdata")],
                    "graph_file_path": [str(tmp_path / "graphs")], "filter": ["*"],
                    "sampling_t": [0.1], "windows": [8], "pred_len": [8],
                    "interval_step": [40]},
        "train": {k: [v] for k, v in dict(TRAIN, model_evaluation="hold_out",
                                          traindata_size=0.75, train_epochs=1).items()},
        "net": {**{k: [v] for k, v in NET.items() if k not in ("gnn_param", "T_h", "T_p", "F")},
                "scaler_type": ["StandardScaler"],
                "gnn_params": {"ResGatedGraphConv": {"bias": [True], "root_weight": [True]}}},
        "loss": {"loss_metric": ["KL divergence"]},
        "optimizer": {k: [v] for k, v in ADAM.items()},
    }
    cfg["net"]["channel_multipliers"] = [[1, 2]]
    # hold_out takes the first value of every list and expands no sub-grid
    # (as in the JAX package): gnn_param given as a list of one
    cfg["net"]["gnn_param"] = [NET["gnn_param"]]
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_spdata.main(["--cfg", str(path), "--train_mode", "hold_out", "--device", "cpu"])
    ckpt = tmp_path / "out/hold_out/trained_model/model_trained"
    assert json.loads((tmp_path / "out/hold_out/train_trace/record_scores.json").read_text())[
        "epoch"] == [0]
    net_param, sd = jio.load_checkpoint(ckpt)
    assert net_param["T_h"] == 8 and net_param["F"] == 1
    jm = jax_model(net_param, None)  # JAX's own tree, its shapes
    want_shapes = {k: v.shape for k, v in flatten_params(jm.params).items()}
    jm.load_state_dict(sd, strict=True)
    assert {k: v.shape for k, v in flatten_params(jm.params).items()} == want_shapes
    port, _ = PU.load_model_from_dir(ckpt.parent, device="cpu")
    np.testing.assert_array_equal(port.scaler_std, jm._scaler.std)
    rng = np.random.default_rng(3)
    batch = rng.normal(size=(2, V + 2, 16, 1)).astype(np.float32)
    adj = np.stack([_graph(rng, V + 2)] * 2)
    key = jax.random.key(1)
    want = float(jax.jit(lambda p: jm.loss_fn(p, batch, adj, key, train=False))(jm.params))
    _, km, kt, ke = jax.random.split(key, 4)
    got = port.loss_fn(batch, adj, train=False,
                       mask_draw=np.asarray(jax.random.uniform(km, (2, V + 2, 8, 1))),
                       t=np.asarray(jax.random.randint(kt, (2,), 1, 51)),
                       noise=np.asarray(jax.random.normal(ke, batch.shape))).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if not torch.cuda.is_available():  # without --device it trains on the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_spdata.main(["--cfg", str(path), "--train_mode", "hold_out"])


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A JAX DiffSTG checkpoint (its own weights, scaler fitted) through the
    port's ``load_model_from_dir``, with its LRU: the same flat weights bit
    for bit, and the same ensemble on JAX's draws."""
    net = dict(NET, scaler_type="StandardScaler", init_num_nodes=V)
    jm = JDiffSTG(net, seed=4)
    jm.scaler_fit(np.random.default_rng(0).normal(size=(40, 16, 1)) * 2 + 1)
    jio.save_checkpoint(tmp_path, "model_trained", jm.state_dict(), net)
    jio.save_config_yaml(tmp_path / "model_trained.yaml", {"net": net, "train": {}})
    port, net_param = PU.load_model_from_dir(tmp_path, device="cpu")
    again, _ = PU.load_model_from_dir(tmp_path, device="cpu")
    assert again is port and net_param["task_model"] == "DiffSTG"
    sd, want = port.state_dict(), jm.state_dict()
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k], np.asarray(want[k]), err_msg=k)
    rng = np.random.default_rng(5)
    hist, adj = rng.normal(size=(V, 8, 1)).astype(np.float32), _graph(rng)
    key = jax.random.key(2)
    e_j = np.asarray(jax.jit(lambda p: jm.sample_fn(p, hist, adj, key, 2))(jm.params))
    e_p = port.sample_fn(hist, adj, n_samples=2, noise=_jax_draws(key, 2, (V, 16, 1), 5))
    np.testing.assert_allclose(e_p.numpy(), e_j, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


# ------------------------------------------------------------------- facade
def _facade_fixture(root, steps=50):
    """A DiffSTG checkpoint directory (the port's seeded weights, a fitted
    scaler, sampling in float32), its graph and an SIS trajectory."""
    rng = np.random.default_rng(9)
    adj = _graph(rng)
    _graphml(root / "graph.graphml", adj)
    net = dict(NET, diffusion_steps=steps, scaler_type="StandardScaler")
    port = DiffSTGModel(net, seed=5, device="cpu")
    port.scaler_fit(rng.normal(size=(30, 16, 1)) * 0.2 + 0.4)
    model_dir = root / "model"
    pio.save_checkpoint(model_dir, "model_trained", port.state_dict(), net)
    pio.save_config_yaml(model_dir / "model_trained.yaml", {
        "dataset": {"windows": 8, "pred_len": 8, "sampling_t": 0.1, "interval_step": 10},
        "train": {"train_model_select": None}, "net": net})
    ys = np.clip((rng.normal(size=(70, V)) * 0.05).cumsum(axis=0) + 0.4, 0, 1)
    data = root / "SIS_dynamic_increase.pt"
    pio.save_pt({"ys_dynamic": ys.astype(np.float32),
                 "ts_dynamic": np.arange(70, dtype=np.float32) * 0.1,
                 "tp_values": np.zeros(70, np.float32)}, data)
    return model_dir, data, root / "graph.graphml"


def _port_on_jax_keys():
    """The port's sampler on the normals of the keys JAX's facade uses:
    seed 0, counter 1 taken by the init, then one key a window."""
    orig = DiffSTGModel.sample_fn
    counter = [1]

    def sample_fn(self, history, adj, generator=None, n_samples=None, noise=None):
        counter[0] += 1
        key = jax.random.fold_in(jax.random.key(0), counter[0])
        shape = (history.shape[0], self.T, self.F)
        noise = _jax_draws(key, n_samples, shape, len(self.step_table()))
        return orig(self, history, adj, generator, n_samples, noise)

    return mock.patch.object(DiffSTGModel, "sample_fn", sample_fn)


def test_facade_matches_jax_window_by_window_with_the_default_infer_params(tmp_path):
    """``uncertainty_ews(task_model DiffSTG)`` without ``infer_params`` on both
    packages: the default {parallel 10, sequential 1, n_z 10, diffusion_steps
    20} overrides the trained 50 steps on both (the schedule is rebuilt over
    20), the window step is the dataset's interval_step, and on JAX's draws
    the MPV agrees window by window at the bar of a sampled chain; the dict
    has JAX's keys and values."""
    model_dir, data, graph_file = _facade_fixture(tmp_path)
    kw = dict(model_save_file=model_dir, data_file=data, dynamic_type="SIS",
              graph_file=graph_file, max_windows=3)
    want = JU.uncertainty_ews(cache_path=tmp_path / "j.pt", **kw)
    with _port_on_jax_keys():
        got = PU.uncertainty_ews(cache_path=tmp_path / "p.pt", device="cpu", **kw)
    assert set(got) == set(want)
    assert got["loaded_net_param"]["diffusion_steps"] == 20
    assert got["loaded_net_param"] == want["loaded_net_param"]
    assert got["sample_window_step"] == want["sample_window_step"] == 10
    for k in ("sampling_t", "windows", "pred_len", "task_model", "uncertainty_source"):
        assert got[k] == want[k], k
    w, g = np.asarray(want["ews"]), np.asarray(got["ews"])
    assert g.shape == w.shape == (3,) and (g > 0).all()
    np.testing.assert_allclose(g, w, rtol=1e-4)
    np.testing.assert_allclose(got["pred_mean"], want["pred_mean"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["time_points"], want["time_points"])
    for gp, wp in zip(got["pred_future_list"], want["pred_future_list"]):
        assert gp.shape == wp.shape == (V, 8, 1, 10)
        np.testing.assert_allclose(gp, wp, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


def test_facade_cache_modes_and_errors(tmp_path):
    """The port's DiffSTG cache (write) serves JAX's facade and the port
    itself with no model built, the MPV bit for bit; the sidecar is written;
    a legacy 3-D cache is normalised; graph_file and network dynamics are
    required; without a device the facade needs a card."""
    model_dir, data, graph_file = _facade_fixture(tmp_path, steps=20)
    kw = dict(model_save_file=model_dir, data_file=data, dynamic_type="SIS",
              graph_file=graph_file, max_windows=2,
              infer_params={"parallel_sampling": 2, "sequential_sampling": 1})
    cache = tmp_path / "c.pt"
    first = PU.uncertainty_ews(cache_path=cache, device="cpu", cache_mode="write", **kw)
    side = json.loads(cache.with_name(cache.name + ".mpv.json").read_text())
    assert side["complete"] and side["n_windows_done"] == 2 and side["raw_space"]
    np.testing.assert_array_equal(side["ews"], np.asarray(first["ews"], np.float64))
    for pkg, extra in ((PU, {"device": "cpu"}), (JU, {})):
        with mock.patch.object(pkg, "load_model_from_dir", side_effect=AssertionError):
            hit = pkg.uncertainty_ews(cache_path=cache, cache_mode="write", **kw, **extra)
        assert hit["ews"] == first["ews"]
    legacy = [p[:, :, 0, :] for p in pio.load_tensor_list(cache)]
    norm = PU.normalize_diffstg_pred_future_list(legacy)
    assert norm[0].shape == (V, 8, 1, 2)
    with pytest.raises(ValueError, match="graph_file"):
        PU.uncertainty_ews(cache_path=tmp_path / "x.pt", device="cpu",
                           **dict(kw, graph_file=None))
    with pytest.raises(ValueError, match="network dynamics"):
        PU.uncertainty_ews(cache_path=tmp_path / "x.pt", device="cpu",
                           **dict(kw, dynamic_type="SLBP"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PU.uncertainty_ews(cache_path=tmp_path / "y.pt", **kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiffSTGModel(NET)


def test_cache_runner_resumes_from_its_partial(tmp_path):
    """``run_diffstg_evaluation_cache`` flushes a fingerprinted `.partial`
    and a sidecar every ``checkpoint_every`` windows; a rerun after a stop
    resumes from them and ends with the uninterrupted sweep's windows."""
    port = DiffSTGModel(dict(NET, parallel_sampling=1, sequential_sampling=2), seed=6,
                        device="cpu")
    rng = np.random.default_rng(1)
    wins = rng.normal(size=(4, V, 8, 1)).astype(np.float32)
    _graphml(tmp_path / "g.graphml", _graph(rng))
    g = graphml_to_adjacency(tmp_path / "g.graphml")
    cache = tmp_path / "run.pt"
    calls = []
    orig = port.evaluation_step

    def stop_after_three(gdata):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return orig(gdata)

    with mock.patch.object(port, "evaluation_step", stop_after_three):
        with pytest.raises(KeyboardInterrupt):
            PU.run_diffstg_evaluation_cache(port, wins, 8, g, cache, device="cpu",
                                            checkpoint_every=2)
    partial = cache.with_name(cache.name + ".partial")
    assert partial.exists() and not cache.exists()
    assert json.loads(cache.with_name(cache.name + ".mpv.json").read_text())[
        "n_windows_done"] == 2
    out = PU.run_diffstg_evaluation_cache(port, wins, 8, g, cache, device="cpu",
                                          checkpoint_every=2)
    assert len(out) == 4 and out[0].shape == (V, 8, 1, 2) and not partial.exists()
    np.testing.assert_array_equal(pio.load_tensor_list(cache)[0], out[0])
