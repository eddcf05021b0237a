"""The port's graph layer held against the JAX package (CPU): graph files,
the spdata corpus and grid, DiffSTG's schedules, the dense GNN convs, FGNN
and the UGnet.

Inputs are made with numpy from a seed; the JAX modules get seeded weights
in the tree of their own init (shapes by ``jax.eval_shape``, no init
compile) and the port the same weights through the flat-dict bridge, so the
flat names are checked with every forward. The graphs are padded: the last
nodes have empty rows, as a batch of mixed-size graphs has.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from upgdm_tpu.models import fgnn as jfgnn
from upgdm_tpu.models import gnn as jgnn
from upgdm_tpu.models import ugnet as jugnet
from upgdm_tpu.ops import graph as jgraph
from upgdm_tpu.ops import schedules as jsched
from upgdm_tpu.utils import config as jconfig
from upgdm_tpu.utils import data_prep as jprep
from upgdm_tpu.utils.io import flatten_params, save_pt
from upgdm_tpu_torch.models import fgnn, gnn, ugnet
from upgdm_tpu_torch.ops import graph, schedules
from upgdm_tpu_torch.utils import config, data_prep
from upgdm_tpu_torch.utils.weights import flax_flat_from_torch, torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
GRAPHS = sorted((REPO / "dataset/train_dataset_graph").glob("*.graphml")) + sorted(
    (REPO / "demo_n100/test_graph").glob("*.graphml"))
V, C = 8, 6


def _padded_adj(rng, B, v_real=(8, 6, 5)):
    """[B, V, V] symmetric 0/1 adjacencies of graphs with v_real[b] nodes,
    padded to V (the padded rows and columns are zero)."""
    adj = np.zeros((B, V, V), np.float32)
    for b in range(B):
        n = v_real[b % len(v_real)]
        a = (rng.uniform(size=(n, n)) < 0.45).astype(np.float32)
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


def _carry(port_module, params):
    """JAX params -> the port's module (strict), with the flat names checked
    both ways (under a parent name, as a model's subtrees always are)."""
    flat = flatten_params({"m": params})
    torch.nn.ModuleDict({"m": port_module}).load_state_dict(torch_state_from_flax(flat),
                                                            strict=True)
    back = flax_flat_from_torch(torch.nn.ModuleDict({"m": port_module}).state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)
    return port_module


# ---------------------------------------------------------------- graph data
def test_graphml_bit_for_bit_on_every_tracked_file():
    """The standard-library parser against networkx's on all 121 tracked
    topologies (120 training graphs and the test graph of demo_n100)."""
    assert len(GRAPHS) == 121
    for path in GRAPHS:
        want = jgraph.graphml_to_adjacency(path).adj
        got = graph.graphml_to_adjacency(path).adj
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=path.name)
        assert (got == got.T).all() and not np.diagonal(got).any()


def test_graphml_weights_directed_and_undeclared_nodes(tmp_path):
    """What networkx reads beyond the tracked files: an edge weight (binarised
    after symmetrising), a directed graph, a self loop and a node an edge names
    before its declaration."""
    text = ('<?xml version="1.0" encoding="utf-8"?>'
            '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
            '<key id="d0" for="edge" attr.name="weight" attr.type="double"/>'
            '<graph edgedefault="directed"><node id="a"/><node id="c"/>'
            '<edge source="a" target="b"><data key="d0">2.5</data></edge>'
            '<edge source="c" target="c"/><edge source="b" target="c"/>'
            '<node id="b"/><node id="d"/></graph></graphml>')
    path = tmp_path / "g.graphml"
    path.write_text(text)
    np.testing.assert_array_equal(graph.graphml_to_adjacency(path).adj,
                                  jgraph.graphml_to_adjacency(path).adj)


def test_dense_graph_padding_and_edge_lists():
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 5, size=(2, 9))
    for sym in (True, False):
        want = jgraph.edge_index_to_adjacency(edges, 5, symmetric=sym)
        got = graph.edge_index_to_adjacency(edges, 5, symmetric=sym)
        np.testing.assert_array_equal(got.adj, want.adj)
        for n in (5, 8):
            w, g = want.padded(n), got.padded(n)
            np.testing.assert_array_equal(g.adj, w.adj)
            np.testing.assert_array_equal(g.node_mask, w.node_mask)
            np.testing.assert_array_equal(g.degree, w.degree)
            assert g.num_nodes == w.num_nodes == n


def _write_corpus(root, names_nodes, T=300, seed=0, nan=False):
    """<root>/spdata/<name>/rec_{0,1}.pt with ys_dynamic [T, V]; the graphs
    are tracked files copied under <root>/graphs/<name>.graphml."""
    rng = np.random.default_rng(seed)
    for name, src in names_nodes:
        g = graph.graphml_to_adjacency(src)
        (root / "graphs").mkdir(parents=True, exist_ok=True)
        (root / "graphs" / f"{name}.graphml").write_bytes(Path(src).read_bytes())
        for r in range(2):
            ys = (rng.normal(size=(T, g.num_nodes)) * 0.1).cumsum(axis=0).astype(np.float32)
            if nan and r == 1:
                ys[T // 2:] = np.nan
            save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(T, dtype=np.float32) * 0.1,
                     "tp_values": np.zeros(T, np.float32)},
                    root / "spdata" / name / f"rec_{r}.pt")


def test_pre_dataset_spdata_bit_for_bit_on_tracked_graphs(tmp_path):
    """A seeded record directory on the tracked 30- and 50-node BA graphs:
    windows (flipped, then original), padded adjacencies and graph ids equal
    to the JAX package's; the smaller graph's padded nodes are empty."""
    srcs = [("ba30", REPO / "dataset/train_dataset_graph/barabasi_albert_30_0.graphml"),
            ("ba50", REPO / "dataset/train_dataset_graph/barabasi_albert_50_0.graphml")]
    _write_corpus(tmp_path, srcs)
    kw = dict(spdata_file_path=tmp_path / "spdata", graph_file_path=tmp_path / "graphs",
              windows=16, pred_len=8, interval_step=40, sampling_t=0.2)
    want = jprep.pre_dataset_spdata(**kw)
    got = data_prep.pre_dataset_spdata(**kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    x, adjs, gids = got
    # the 30-node graph padded to 50: its last 20 nodes empty, every node of
    # the tracked BA graphs has an edge
    assert ((adjs.sum(axis=2) > 0).sum(axis=1) == [30, 50]).all()
    assert not x[gids == 0][:, 30:].any() and not adjs[0, 30:].any()
    # the empty corpus and a diverged record
    empty = data_prep.pre_dataset_spdata(**dict(kw, filter="none*"))
    for g, w in zip(empty, jprep.pre_dataset_spdata(**dict(kw, filter="none*"))):
        assert g.shape == w.shape and g.dtype == w.dtype
    _write_corpus(tmp_path / "bad", srcs[:1], nan=True)
    with pytest.raises(ValueError, match="non-finite ys_dynamic.*ba30"):
        data_prep.pre_dataset_spdata(**dict(kw, spdata_file_path=tmp_path / "bad/spdata",
                                            graph_file_path=tmp_path / "bad/graphs"))


def test_spdata_grid_equals_jax():
    """The DiffSTG grid config and a sub-grid with f_gnn_params."""
    with open(REPO / "configs/grid_search/diffusion_model_DiffSTG.yaml") as f:
        cfg = yaml.safe_load(f)
    args = (cfg["train"], cfg["net"], cfg["loss"], cfg["optimizer"])
    assert config.grid_parameters_generative_learning_spdata(*args) == \
        jconfig.grid_parameters_generative_learning_spdata(*args)
    net = dict(cfg["net"], f_gnn_name=["GCNConv", "SAGEConv"],
               f_gnn_params={"GCNConv": {"bias": [True, False]}, "SAGEConv": {"aggr": ["max"]}})
    args = (cfg["train"], net, cfg["loss"], cfg["optimizer"])
    got, hp = config.grid_parameters_generative_learning_spdata(*args)
    assert (got, hp) == jconfig.grid_parameters_generative_learning_spdata(*args)
    # Td_h x multipliers x gnn names x (f_gnn_name, its sub-grid): 2 x 2 x 3 x (2 + 1)
    assert len(got) == 36


# ----------------------------------------------------------------- schedules
@pytest.mark.parametrize("kind", ["linear", "quad", "cosine"])
def test_diffstg_schedule_bit_equal(kind):
    for T in (20, 200):
        want, got = jsched.diffstg_schedule(T, kind), schedules.diffstg_schedule(T, kind)
        for f in ("beta", "alpha", "alphabar"):
            assert getattr(got, f).dtype == np.float64
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.T == want.T and got.alpha[0] == 1.0
        ts = np.arange(1, T + 1)
        np.testing.assert_array_equal(got.snr(ts), want.snr(ts))
        for sched in ("linear", "cosine"):
            for steps in (5, 20, T):
                assert schedules.inference_time_pairs(sched, T, steps) == \
                    jsched.inference_time_pairs(sched, T, steps)
    with pytest.raises(ValueError):
        schedules.diffstg_schedule(10, "sigmoid")
    with pytest.raises(ValueError):
        schedules.inference_time_pairs("quad", 10, 5)


# -------------------------------------------------------------- GNN convs
CONVS = [
    ("GCNConv", {}), ("GCNConv", {"add_self_loops": False, "bias": False}),
    ("GraphConv", {}), ("GraphConv", {"aggr": "mean"}),
    ("SAGEConv", {}), ("SAGEConv", {"aggr": "max"}), ("SAGEConv", {"aggr": "add"}),
    ("GATConv", {"heads": 2, "dropout": 0.05, "aggr": "add"}),
    ("GATConv", {"heads": 2, "concat": False}),
    ("GATv2Conv", {"heads": 3}),
    ("ResGatedGraphConv", {"bias": True, "root_weight": True}),
    ("ResGatedGraphConv", {"root_weight": False}),
    ("GatedGraphConv", {"num_layers": 2}),
    ("AGNNConv", {}), ("AGNNConv", {"aggregation": "mean"}),
    ("PNAConv", {"deg": [0, 3, 4, 2, 1]}),
    ("PNAConv", {"deg": [0, 3, 4], "towers": 2, "pre_layers": 2, "post_layers": 2,
                 "aggregators": ["mean", "sum", "min", "max", "var"], "divide_input": True}),
]


@pytest.mark.parametrize("name,param", CONVS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONVS)])
def test_gnn_conv_matches_jax_on_a_padded_graph(name, param):
    """Forward at atol 1e-5 on [B, V, C] features over padded [B, V, V]
    graphs, and over one [V, V] adjacency broadcast to the batch; the flat
    parameter names are flax's (``_carry``)."""
    rng = np.random.default_rng(7)
    out = C if name == "AGNNConv" else 12
    x = rng.normal(size=(3, V, C)).astype(np.float32)
    adj = _padded_adj(rng, 3)
    jm = jgnn.gnn_conv(name, out, param)
    params = _seeded_params(jm, 11, x, adj)
    pm = _carry(gnn.gnn_conv(name, C, out, param), params)
    for a in (adj, adj[1]):
        want = np.asarray(jm.apply({"params": params}, x, a))
        got = pm(torch.from_numpy(x), torch.from_numpy(a)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        gnn.gnn_conv("ChebConv", C, out)


def test_fgnn_conv_and_clique_search_match_jax():
    rng = np.random.default_rng(3)
    adj = _padded_adj(rng, 1)[0]
    assert fgnn.find_cliques(adj) == jfgnn.find_cliques(adj)
    assert fgnn.find_maximal_cliques(adj) == jfgnn.find_maximal_cliques(adj)
    nv, nf, E, dv, df, de = 6, 4, 10, 5, 3, 2
    var = rng.normal(size=(nv, dv)).astype(np.float32)
    fac = rng.normal(size=(nf, df)).astype(np.float32)
    v2f = np.stack([rng.integers(0, nv, E), rng.integers(0, nf, E)])
    f2v = np.stack([rng.integers(0, nf, E), rng.integers(0, nv, E)])
    ea = rng.normal(size=(E, de)).astype(np.float32)
    jm = jfgnn.FGNNConv(output_vdim=7, factor_dim=df, net_num_layers=3)
    params = _seeded_params(jm, 5, var, fac, v2f, ea, f2v)
    want = jm.apply({"params": params}, var, fac, v2f, ea, f2v)
    pm = _carry(gnn.gnn_conv("FGNNConv", dv, 7, {"factor_dim": df, "net_num_layers": 3,
                                                  "edge_dim": de}), params)
    got = pm(torch.from_numpy(var), torch.from_numpy(fac), torch.from_numpy(v2f),
             torch.from_numpy(ea), torch.from_numpy(f2v))
    for g, w in zip(got, want):  # the Q @ M products reach ~1e2: 1e-5 of the scale
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------------------- UGnet
@pytest.mark.parametrize("mults,gnn_name", [([1, 2], "ResGatedGraphConv"),
                                            ([2, 2], "GATConv")])
def test_ugnet_matches_jax(mults, gnn_name):
    """T_h = T_p = 8, d_h 4, Td_h 4, two blocks a level, on padded graphs
    with timesteps up to 300 (above bf16's exact integers); atol 1e-5 of the
    output's scale."""
    rng = np.random.default_rng(2)
    B, T = 3, 16
    gp = {"heads": 2} if gnn_name == "GATConv" else None
    kw = dict(d_h=4, T_h=8, T_p=8, F=1, n_blocks=2, gnn_name=gnn_name, gnn_param=gp, td_h=4)
    jm = jugnet.UGnet(channel_multipliers=tuple(mults), **kw)
    x = rng.normal(size=(B, V, T, 1)).astype(np.float32)
    xm = rng.normal(size=(B, V, T, 1)).astype(np.float32)
    t = np.array([1.0, 57.0, 300.0], np.float32)
    adj = _padded_adj(rng, B)
    params = _seeded_params(jm, 4, x, t, xm, adj)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x, t, xm, adj))(params))
    pm = _carry(ugnet.UGnet(channel_multipliers=mults, **kw), params)
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, (x, t, xm, adj))).numpy()
    assert got.shape == (B, V, T, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_time_conv_transpose_is_the_dilated_unflipped_conv():
    """TimeConvTranspose (the ResidualBlock's up-sampling, kernel t_in + 1,
    and the stride-2 Upsample) against JAX's; ``F.conv_transpose1d`` on the
    same weights, the obvious port, gives another result."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    for k, s, p in ((17, 1, 2), (4, 2, 1)):
        jm = jugnet.TimeConvTranspose(6, k, s, p)
        params = _seeded_params(jm, 1, x)
        want = np.asarray(jm.apply({"params": params}, x))
        pm = _carry(ugnet.TimeConvTranspose(4, 6, k, s, p), params)
        got = pm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # flax (k, C, out) -> [C, out, k], the layout conv_transpose1d takes
        w = torch.from_numpy(np.asarray(params["kernel"]).transpose(1, 2, 0).copy())
        h = torch.from_numpy(x).reshape(6, 5, 4).transpose(1, 2)
        naive = F.conv_transpose1d(h, w, torch.from_numpy(np.asarray(params["bias"])),
                                   stride=s, padding=p).transpose(1, 2).reshape(want.shape)
        assert np.abs(naive.numpy() - want).max() > 1e-2
