"""NsDiff_spatial and the GNN registries held against the JAX package (CPU):
the activation / norm / pool registries, the spatial UGnet and f(x), the
loss and gradients of every stage, the sampler on JAX's draws, bf16
sampling, checkpoints of every stage both ways, ``load_pretrain``, the
spdata grid and training through the ``adj`` path, the per-graph cache
sweep, and the factory over every family the JAX package builds.

Both packages run on the same weights: the port's, drawn from a seed, or
seeded normals in the tree of the JAX module's init (shapes by
``jax.eval_shape``: no init compile). The JAX models skip their init and
hold the port's weights; the timesteps and normals JAX draws from its keys
reach the port through the ``t``/``noise`` seams of ``loss_fn`` and
``sample_fn``, so what is compared is the arithmetic, float32 on both sides.
Sizes: V 5, W/P 16/8, d_model 16, one encoder and one decoder layer, fT_h
and Td_h 4, 10 diffusion steps.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from upgdm_tpu.models import nsdiff_spatial as jsp
from upgdm_tpu.models import registries as jreg
from upgdm_tpu.models.factory import diffusion_models as jax_factory
from upgdm_tpu.utils import config as jconfig
from upgdm_tpu.utils.io import flatten_params, unflatten_params
from upgdm_tpu_torch.eval import uncertainty as PU
from upgdm_tpu_torch.models import nsdiff_spatial as psp
from upgdm_tpu_torch.models import registries as preg
from upgdm_tpu_torch.models.factory import diffusion_models
from upgdm_tpu_torch.ops.graph import DenseGraph
from upgdm_tpu_torch.train.loop import run_training
from upgdm_tpu_torch.utils import config
from upgdm_tpu_torch.utils import io as pio
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch, torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
V, W, P, STEPS = 5, 16, 8, 10
NET = dict(
    dataset_nf=1, windows=W, pred_len=P, rolling_length=4, diffusion_steps=STEPS,
    d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16, dropout=0.0,
    p_hidden_dims=[8, 8], p_hidden_layers=2, fT_h=4, d_h=4, Td_h=4,
    channel_multipliers=[1, 2], n_blocks=1, gnn_name="GCNConv",
    gnn_param={"add_self_loops": True}, f_gnn_name="GCNConv", n_z_samples=4,
    task_model="NsDiff_spatial", sampling_dtype="float32", scaler_type=None,
)
STAGES = ("pretrain_f", "pretrain_g", "NsDiff_model")
# the bars of the port's module tests (tests/test_torch_port_graph.py), of its
# losses and gradients (tests/test_torch_port_train.py), of a sampled chain
# (tests/test_torch_parity.py) and of two sampling dtypes (tests/test_models_e2e.py)
ATOL, LOSS_RTOL, GRAD_REL = 1e-5, 1e-4, 1e-3
SAMPLE_RTOL, SAMPLE_ATOL, MPV_REL = 2e-4, 2e-5, 0.01


def _graphs(rng, B, v_real=(5, 4, 3)):
    """[B, V, V] symmetric 0/1 adjacencies padded to V."""
    adj = np.zeros((B, V, V), np.float32)
    for b in range(B):
        n = v_real[b % len(v_real)]
        a = (rng.uniform(size=(n, n)) < 0.5).astype(np.float32)
        a = ((a + a.T) > 0).astype(np.float32)
        np.fill_diagonal(a, 0.0)
        adj[b, :n, :n] = a
    return adj


def _seeded_params(module, seed, *args, **kw):
    """Seeded normal weights (std 0.3) in the tree of ``module.init``."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kw)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * 0.3).astype(np.float32)), shapes)


def _carry(port_module, params, name="m"):
    """JAX params -> the port's module (strict) under the parent ``name``,
    the flat names checked both ways."""
    flat = flatten_params({name: params})
    holder = torch.nn.ModuleDict({name: port_module})
    holder.load_state_dict(torch_state_from_flax(flat), strict=True)
    back = flax_flat_from_torch(holder.state_dict())
    assert sorted(back) == sorted(flat)
    return port_module


def _weights(port):
    return {k: v for k, v in port.state_dict().items() if not k.startswith("scaler")}


def jax_model(net, flat, select="NsDiff_model"):
    """JAX's NsDiffSpatialModel(net) holding the flat weights ``flat`` (its
    modules built, their init skipped)."""

    def init(self):
        self._build_modules()
        self.params = jax.tree.map(jnp.asarray, unflatten_params(dict(flat)))
        self.next_key()

    with mock.patch.object(jsp.NsDiffSpatialModel, "_init_params", init):
        return jsp.NsDiffSpatialModel(net, train_model_select=select)


# ---------------------------------------------------------------- registries
@pytest.mark.parametrize("name", ["relu", "leaky_relu", "elu", "gelu", "sigmoid", "tanh",
                                  "softplus", "identity"])
def test_gnn_act_matches_jax(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = preg.gnn_act(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jreg.gnn_act(name)(x)), rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        preg.gnn_act("swish")


@pytest.mark.parametrize("norm,masked", [("BatchNorm", False), ("LayerNorm", False),
                                         ("GraphNorm", False), ("GraphNorm", True),
                                         ("identity", False)])
def test_gnn_norm_matches_jax(norm, masked):
    """Over [B, V, C] node features; BatchNorm with running statistics,
    LayerNorm at flax's epsilon, GraphNorm with and without a node mask,
    weights seeded in flax's tree and carried through the bridge (GraphNorm's
    ``scale`` and ``alpha``)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, V, 6)).astype(np.float32) * 2 + 1
    mask = np.arange(V)[None] < np.array([5, 3, 1])[:, None]
    args = (x, mask) if masked else (x,)
    pm = preg.gnn_norm(norm, 6)
    if norm == "identity":
        np.testing.assert_array_equal(pm(torch.from_numpy(x)).numpy(), x)
        return
    jm = jreg.gnn_norm(norm)
    if norm == "BatchNorm":
        variables = {"params": {"scale": rng.normal(size=6).astype(np.float32),
                                "bias": rng.normal(size=6).astype(np.float32)},
                     "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                                     "var": rng.uniform(0.5, 2, size=6).astype(np.float32)}}
        want = np.asarray(jm.apply(variables, x))
        p, s = variables["params"], variables["batch_stats"]
        pm.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                            "bias": torch.from_numpy(p["bias"]),
                            "running_mean": torch.from_numpy(s["mean"]),
                            "running_var": torch.from_numpy(s["var"]),
                            "num_batches_tracked": torch.tensor(0)})
    else:
        params = _seeded_params(jm, 2, *args)
        want = np.asarray(jm.apply({"params": params}, *args))
        _carry(pm, params, f"{norm}_0")
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())
    with pytest.raises(ValueError):
        preg.gnn_norm("InstanceNorm", 6)


@pytest.mark.parametrize("name", ["mean", "global_max_pool", "add"])
@pytest.mark.parametrize("masked", [False, True])
def test_gnn_pool_matches_jax(name, masked):
    """Pools over the node axis; the masked max fills with -inf and a graph
    with no node gives mean 0 (the max(count, 1) guard) and max -inf."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, V, 3)).astype(np.float32)
    mask = np.arange(V)[None] < np.array([5, 2, 1, 0])[:, None]
    args = (x, mask) if masked else (x,)
    want = np.asarray(jreg.gnn_pool(name)(*args))
    got = preg.gnn_pool(name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        preg.gnn_pool("median")


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("mults,gnn", [((1, 2), ("GCNConv", {"add_self_loops": True})),
                                       ((2, 2), ("GATConv", {"heads": 2}))])
def test_spatial_ugnet_matches_jax(mults, gnn):
    """(eps, sigma) of NsDiffSpatialUGnet on padded graphs, one adjacency
    per graph and one for all, timesteps to 9: atol 1e-5 of each output's
    scale."""
    rng = np.random.default_rng(4)
    B = 3
    kw = dict(d_h=4, pred_len=P, F=1, n_blocks=2, gnn_name=gnn[0], gnn_param=gnn[1], td_h=4)
    jm = jsp.NsDiffSpatialUGnet(channel_multipliers=mults, **kw)
    ys = [rng.normal(size=(B, V, P, 1)).astype(np.float32) for _ in range(3)]
    ys[2] = np.abs(ys[2]) + 0.1
    t = np.array([0, 4, 9], np.int32)
    params = _seeded_params(jm, 5, *ys, t, _graphs(rng, B))
    pm = _carry(psp.NsDiffSpatialUGnet(channel_multipliers=mults, **kw), params)
    for adj in (_graphs(rng, B), _graphs(rng, 1)[0]):
        want = jax.jit(lambda p, a: jm.apply({"params": p}, *ys, t, a))(params, adj)
        with torch.no_grad():
            got = pm(*map(torch.from_numpy, ys), torch.from_numpy(t), torch.from_numpy(adj))
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == (B, V, P, 1)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL * np.abs(w).max())


def test_ns_transformer_spatial_matches_jax():
    """f(x) on node-major [B, V, T, F] with padded graphs: pred and dec_out
    at atol 1e-5 of their scale. With the node and time axes swapped the
    shapes still fit; the result must not."""
    rng = np.random.default_rng(6)
    B = 2
    kw = dict(seq_len=W, label_len=W // 2, pred_len=P, enc_in=1, d_model=16, n_heads=2,
              e_layers=1, d_layers=1, d_ff=16, dropout=0.0, p_hidden_dims=(8, 8), fT_h=4,
              f_gnn_name="GCNConv", f_gnn_param={"add_self_loops": True})
    jm = jsp.NSTransformerSpatial(**kw)
    x = (rng.normal(size=(B, V, W, 1)) * 0.3 + 1).astype(np.float32).cumsum(axis=2) / 4
    adj = _graphs(rng, B)
    params = _seeded_params(jm, 7, x, adj)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, adj))(params)
    pm = _carry(psp.NSTransformerSpatial(**kw), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(adj))
    assert got[0].shape == (B, V, P, 1) and got[1].shape == (B, V, W // 2 + P, 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL * np.abs(w).max())


# ---------------------------------------------------------------- the model
def _batch(rng, B):
    x = (rng.normal(size=(B, V, W + P, 1)) * 0.2).cumsum(axis=2) + 1.0
    return x.astype(np.float32), _graphs(rng, B)


@pytest.mark.parametrize("select,freeze", [("pretrain_f", False), ("pretrain_g", False),
                                           ("NsDiff_model", False), ("NsDiff_model", True)])
def test_loss_and_gradients_match_jax(select, freeze):
    """Every stage's loss on JAX's antithetic t and normals: rtol 1e-4, each
    gradient leaf within 1e-3 of its largest |jax.grad|; a stage's
    checkpoint holds all three subtrees, as JAX's, and the trainable mask is
    JAX's; ``freeze_pretrain`` leaves the KL term."""
    net = dict(NET, freeze_pretrain=freeze)
    port = diffusion_models("NsDiff_spatial", net, train_model_select=select, seed=1,
                            device="cpu")
    jm = jax_model(net, _weights(port), select)
    assert {k.split(".")[0] for k in _weights(port)} == set(jm.params)
    assert port.trainable_mask() == jm.trainable_mask()
    rng = np.random.default_rng(8)
    batch, adj = _batch(rng, 3)
    key = jax.random.key(2)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, adj, key, select=select, train=True)))(jm.params)
    _, kt, ke = jax.random.split(key, 3)
    loss = port.loss_fn(batch, adj, select=select,
                        t=np.asarray(jm.antithetic_t(kt, 3, STEPS)),
                        noise=np.asarray(jax.random.normal(ke, (3, V, P, 1))))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    got = flax_flat_from_torch({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                for n, p in port.net.named_parameters()})
    want = flatten_params(grads_j)
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=GRAD_REL * top,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_samples():
    """One JAX sampler run shared by the per-sample tests: (port model, its
    history [1, V, W, 1], adj [V, V], JAX's samples [1, V, P, 1, S], the
    normals it drew)."""
    port = diffusion_models("NsDiff_spatial", NET, seed=3, device="cpu")
    jm = jax_model(NET, _weights(port))
    rng = np.random.default_rng(9)
    batch, adj = _batch(rng, 1)
    hist, adj = batch[:, :, :W], adj[0]
    key = jax.random.key(4)
    S = 4
    want = np.asarray(jax.jit(lambda p: jm.sample_fn(p, hist, adj, key, S))(jm.params))

    def one(k):  # ops/diffusion.py::nsdiff_p_sample_loop's draws for one member
        k, k0 = jax.random.split(k)
        shape = (1, V, P, 1)
        zs = jax.vmap(lambda kk: jax.random.normal(kk, shape))(jax.random.split(k, STEPS - 1))
        return jnp.concatenate([jax.random.normal(k0, shape)[None], zs])

    z = np.asarray(jax.vmap(one)(jax.random.split(key, S)))  # [S, T, 1, V, P, 1]
    return port, hist, adj, want, [z[:, i] for i in range(STEPS)]


def test_sample_fn_matches_jax_on_its_draws(jax_samples):
    """S = 4 members on JAX's normals: every sample at rtol 2e-4 / atol 2e-5,
    output [B, V, P, F, S]; ``evaluation_step`` takes one graph."""
    port, hist, adj, want, noise = jax_samples
    got = port.sample_fn(hist, adj, n_z_samples=4, noise=noise).numpy()
    assert got.shape == want.shape == (1, V, P, 1, 4)
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    x = np.concatenate([hist[0], np.zeros((V, P, 1), np.float32)], axis=1)
    outs, truth = port.evaluation_step({"x": x, "adj": adj})
    assert outs.shape == (V, P, 1, 4) and np.isfinite(outs.numpy()).all()
    np.testing.assert_array_equal(truth.numpy(), x[:, W:])
    assert port.evaluation_step({"x": hist[0], "adj": adj})[1] is None


def test_bf16_sampling_mpv_within_1pct_of_float32():
    """bf16 sampling (the denoiser, its inputs and the dense adjacency cast;
    f, g, the chain and the posterior float32) at the configuration of the
    JAX package's own bar (tests/test_models_e2e.py:278-312: V 10, 48
    members, the JAX model's initial weights, carried over), on the same
    draws: ensemble MPV within 1% of float32's (JAX measured 0.12% there),
    samples differ, and the adjacency reaches the cast denoiser as bf16.
    On other random weights the chain's spread, and with it the gap, varies
    by orders of magnitude, in both packages alike."""
    cfg = dict(
        dataset_nf=1, windows=24, pred_len=8, rolling_length=8, diffusion_steps=12,
        scaler_type=None, d_model=32, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
        p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=48, task_model="NsDiff_spatial",
        d_h=4, channel_multipliers=[1, 2], n_blocks=2, gnn_name="GCNConv", Td_h=4, fT_h=4,
    )
    rng = np.random.default_rng(0)
    Vb = 10
    adj = (rng.uniform(size=(Vb, Vb)) < 0.3).astype(np.float32)
    adj = ((adj + adj.T) > 0).astype(np.float32)
    np.fill_diagonal(adj, 0)
    x = rng.normal(size=(2, Vb, 24, 1)).astype(np.float32)
    flat = flatten_params(jsp.NsDiffSpatialModel(dict(cfg, sampling_dtype="float32")).params)
    m32 = diffusion_models("NsDiff_spatial", dict(cfg, sampling_dtype="float32"), device="cpu")
    m16 = diffusion_models("NsDiff_spatial", cfg, device="cpu")
    for m in (m32, m16):
        m.load_state_dict({k: np.asarray(v) for k, v in flat.items()})
    assert m16.sampling_dtype() == torch.bfloat16
    e32 = m32.sample_fn(x, adj, torch.Generator().manual_seed(1)).numpy()
    e16 = m16.sample_fn(x, adj, torch.Generator().manual_seed(1)).numpy()
    mpv16, mpv32 = e16.var(axis=-1).mean(), e32.var(axis=-1).mean()
    assert abs(mpv16 - mpv32) / mpv32 < MPV_REL
    assert np.abs(e16 - e32).max() > 0
    seen = []
    den = m16._cast("model", torch.bfloat16)
    with mock.patch.object(type(den), "forward", lambda self, *a: seen.append(a[4].dtype)
                           or (a[0].float(), a[0].float().abs())):
        m16.sample_fn(x, adj, n_z_samples=2)
    assert set(seen) == {torch.bfloat16}


@pytest.mark.parametrize("select", STAGES)
def test_checkpoints_of_every_stage_load_both_ways(select, tmp_path):
    """A port stage's ``model_trained`` loads strictly into JAX's model of
    that stage, and JAX's (its own tree) into the port's, bit for bit."""
    port = diffusion_models("NsDiff_spatial", NET, train_model_select=select, seed=5,
                            device="cpu")
    port.scaler_fit(np.random.default_rng(1).normal(size=(4, V, W, 1)))
    pio.save_checkpoint(tmp_path / "p", "model_trained", port.state_dict(), NET)
    from upgdm_tpu.utils import io as jio

    _, sd = jio.load_checkpoint(tmp_path / "p/model_trained")
    jm = jax_model(NET, {k: np.zeros_like(v) for k, v in _weights(port).items()}, select)
    jm.load_state_dict(sd, strict=True)
    flat = flatten_params(jm.params)
    for k, v in _weights(port).items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    jm.params = jax.tree.map(lambda a: a * 0.5 + 0.1, jm.params)
    jio.save_checkpoint(tmp_path / "j", "model_trained", jm.state_dict(), NET)
    _, sdj = pio.load_checkpoint(tmp_path / "j/model_trained")
    back = diffusion_models("NsDiff_spatial", NET, train_model_select=select, device="cpu")
    back.load_state_dict(sdj, strict=True)
    for k, v in flatten_params(jm.params).items():
        np.testing.assert_array_equal(back.state_dict()[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(back.scaler_std, port.scaler_std)


def test_load_pretrain_takes_the_stage_subtrees(tmp_path):
    """The NsDiff_model stage with ``load_pretrain`` takes g(x) from the
    pretrain_g directory and, with ``load_pretrain_f``, f(x) from the
    pretrain_f one; the denoiser keeps its own draw."""
    dirs = {}
    for i, select in enumerate(("pretrain_f", "pretrain_g")):
        m = diffusion_models("NsDiff_spatial", NET, train_model_select=select, seed=10 + i,
                             device="cpu")
        pio.save_checkpoint(tmp_path / select, "model_trained", m.state_dict(), NET)
        dirs[select] = m
    net = dict(NET, load_pretrain=True, load_pretrain_f=True,
               pretrain_f_path=str(tmp_path / "pretrain_f"),
               pretrain_g_path=str(tmp_path / "pretrain_g"))
    m = diffusion_models("NsDiff_spatial", net, seed=12, device="cpu")
    sd, fresh = m.state_dict(), diffusion_models("NsDiff_spatial", NET, seed=12,
                                                 device="cpu").state_dict()
    for k in sd:
        src = (dirs["pretrain_f"] if k.startswith("cond_pred_model.") else
               dirs["pretrain_g"] if k.startswith("cond_pred_model_g.") else None)
        want = fresh[k] if src is None else src.state_dict()[k]
        np.testing.assert_array_equal(sd[k], want, err_msg=k)


# ---------------------------------------------------------- training, sweep
def test_spdata_grid_equals_jax():
    """The NsDiff_spatial grid config with its nested gnn_params /
    f_gnn_params sub-grids expands as the JAX package's."""
    with open(REPO / "configs/grid_search/diffusion_model_NsDiff_spdata.yaml") as f:
        cfg = yaml.safe_load(f)
    args = (cfg["train"], cfg["net"], cfg["loss"], cfg["optimizer"])
    got, hp = config.grid_parameters_generative_learning_spdata(*args)
    assert (got, hp) == jconfig.grid_parameters_generative_learning_spdata(*args)
    assert {(n["gnn_name"], str(n["gnn_param"]), n["f_gnn_name"], str(n["f_gnn_param"]))
            for _, n, _, _ in got} == {("GCNConv", "{'add_self_loops': True}", "GCNConv",
                                        "{'add_self_loops': True}")}


def test_three_stages_through_run_training_with_adj(tmp_path):
    """pretrain_f -> pretrain_g -> NsDiff_model with ``load_pretrain`` on a
    mixed-size corpus through ``run_training(adj=(adjs, train_ids,
    val_ids))``: finite records, every stage's checkpoint holds the three
    subtrees, the last starts from the stages' f and g, and its loss on
    its batch is JAX's on the same draws."""
    rng = np.random.default_rng(11)
    x, _ = _batch(rng, 12)
    adjs = _graphs(rng, 2, (5, 3))
    gids = rng.integers(0, 2, size=12)
    x[gids == 1, 3:] = 0.0
    train = dict(train_batch_size=4, val_batch_size=4, train_epochs=2, test_set=True,
                 ckpt=False)
    adam = dict(optimizer_name="Adam", lr=1e-3, weight_decay=0.0)
    net = dict(NET, scaler_type="StandardScaler")
    for select in ("pretrain_f", "pretrain_g"):
        rs = run_training(x[:8], x[8:], dict(train, train_model_select=select), dict(net), {},
                          adam, tmp_path / select, adj=(adjs, gids[:8], gids[8:]),
                          device="cpu")
        assert np.isfinite(rs["train_scores"]).all() and len(rs["val_scores"]) == 2
    net = dict(net, load_pretrain=True, load_pretrain_f=True,
               pretrain_f_path=str(tmp_path / "pretrain_f/trained_model"),
               pretrain_g_path=str(tmp_path / "pretrain_g/trained_model"))
    rs = run_training(x[:8], x[8:], dict(train, train_model_select="NsDiff_model"), net, {},
                      adam, tmp_path / "main", adj=(adjs, gids[:8], gids[8:]), device="cpu")
    assert np.isfinite(rs["train_scores"]).all()
    sds = {s: pio.load_checkpoint(tmp_path / s / "trained_model/model_trained")[1]
           for s in ("pretrain_f", "pretrain_g", "main")}
    for sd in sds.values():
        assert {k.split(".")[0] for k in sd} == {"cond_pred_model", "cond_pred_model_g",
                                                 "model", "scaler_mean", "scaler_std"}
    # pretrain_f trained f only; pretrain_g left its f at the initial draw
    k = "cond_pred_model.decoder.Dense_0.kernel"
    assert not np.array_equal(sds["pretrain_f"][k], sds["pretrain_g"][k])
    model, _ = PU.load_model_from_dir(tmp_path / "main/trained_model", device="cpu")
    jm = jax_model(dict(net, load_pretrain=False), _weights(model))
    batch = model.scaler_transform(x[8:])
    adj = adjs[gids[8:]]
    key = jax.random.key(6)
    want = float(jax.jit(lambda p: jm.loss_fn(p, batch, adj, key, train=False))(jm.params))
    _, kt, ke = jax.random.split(key, 3)
    got = model.loss_fn(batch, adj, train=False, t=np.asarray(jm.antithetic_t(kt, 4, STEPS)),
                        noise=np.asarray(jax.random.normal(ke, (4, V, P, 1)))).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_per_graph_cache_sweep_as_the_n100_demo(tmp_path):
    """``run_diffstg_evaluation_cache`` takes NsDiff_spatial's
    ``evaluation_step({"x", "adj"})`` one graph at a time, as
    examples/n100_scale_demo.py sweeps it: [V, P, F, S] per window, written
    and read back, the same ensembles with a cache hit."""
    rng = np.random.default_rng(12)
    model = diffusion_models("NsDiff_spatial", dict(NET, scaler_type="StandardScaler"),
                             seed=7, device="cpu")
    wins = (rng.normal(size=(3, V, W, 1)) * 0.1).cumsum(axis=2).astype(np.float32) + 0.5
    model.scaler_fit(wins)
    graph = DenseGraph(_graphs(rng, 1)[0])
    out = PU.run_diffstg_evaluation_cache(model, wins, P, graph, tmp_path / "c.pt",
                                          device="cpu", checkpoint_every=2)
    assert len(out) == 3 and all(o.shape == (V, P, 1, 4) and np.isfinite(o).all()
                                 for o in out)
    hit = PU.run_diffstg_evaluation_cache(model, wins, P, graph, tmp_path / "c.pt",
                                          device="cpu")
    for a, b in zip(out, hit):
        np.testing.assert_array_equal(a, b)
    _, mpv = PU.summarize_pred_future_list(out, model=model)
    assert np.isfinite(mpv).all() and (np.asarray(mpv) > 0).all()


# --------------------------------------------------------------- the factory
FAMILIES = {
    "NsDiff": dict(dataset_nf=1, windows=W, pred_len=P, rolling_length=4, diffusion_steps=5,
                   d_model=8, n_heads=2, e_layers=1, d_layers=1, d_ff=8,
                   p_hidden_dims=[8, 8]),
    "NsDiff_model_variants": dict(dataset_nf=1, windows=W, pred_len=P, rolling_length=4,
                                  diffusion_steps=5, d_model=8, n_heads=2, e_layers=1,
                                  d_layers=1, d_ff=8, p_hidden_dims=[8, 8]),
    "TMDM": dict(dataset_nf=1, windows=W, pred_len=P, diffusion_steps=5, d_model=8, n_heads=2,
                 e_layers=1, d_layers=1, d_ff=8, p_hidden_dims=[8, 8]),
    "DiffSTG": dict(T_h=8, T_p=8, F=1, d_h=4, Td_h=4, channel_multipliers=[1, 2], n_blocks=1,
                    diffusion_steps=5, gnn_name="GCNConv"),
    "NsDiff_spatial": NET,
    "DiffusionTS": dict(dataset_nf=1, windows=W, pred_len=P, timesteps=5, diffusion_steps=5,
                        n_layer_enc=1, n_layer_dec=1, d_model=8, n_heads=2),
}


@pytest.mark.parametrize("task_model", sorted(FAMILIES))
def test_factory_builds_every_family_of_the_jax_package(task_model):
    """Every ``task_model`` of upgdm_tpu/models/factory.py builds on the CPU
    through the port's factory and yields a finite loss on a batch of its
    layout; an unknown name raises the JAX factory's ValueError in both."""
    kw = {"train_model_select": "cond_mean"} if task_model == "NsDiff_model_variants" else {}
    port = diffusion_models(task_model, dict(FAMILIES[task_model]), device="cpu", **kw)
    assert port.device.type == "cpu" and next(port.net.parameters()).device.type == "cpu"
    rng = np.random.default_rng(0)
    if task_model in ("DiffSTG", "NsDiff_spatial"):
        loss = port.loss_fn(rng.normal(size=(2, V, 16 if task_model == "DiffSTG" else W + P,
                                             1)), _graphs(rng, 2))
    else:
        loss = port.loss_fn(rng.normal(size=(2, W + P, 1)))
    assert torch.isfinite(loss)
    for fac in (diffusion_models, jax_factory):
        with pytest.raises(ValueError, match="the definition don't exit"):
            fac("NoSuchModel", {})
