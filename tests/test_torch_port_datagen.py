"""The port's data layer beside the JAX package's (CPU): the graph
generators and statistics without networkx, GraphML, the graph library,
the dataset drivers and their CLI, the Bury corpus and the classic EWS
indicators without pandas.

The generators copy networkx 3.6.1's algorithms and order of random draws,
so under the same seeds (and the same global ``random`` state where the JAX
package hands networkx no seed) the adjacency is networkx's bit for bit, and
the global state is left where networkx leaves it. The string-hash seeds of
the graph library and of the network datasets are equal within one process,
so each package's files are compared with the other's. ``bury_sim`` and every
``ews_classic`` function but the rolling variance run the JAX package's numpy
operations, and are held bit for bit; the rolling variance replaces pandas'
online update by a two-pass variance a window and is held to pandas at rtol
1e-12.
"""
import random
import subprocess
import sys
from pathlib import Path

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

from test_ews_goldens import GOLDEN_CLASSIC_EWS, GOLDEN_CLASSIC_EWS_LOWESS, _series
from upgdm_tpu.data import bury_sim as JB
from upgdm_tpu.data import generate as JGen
from upgdm_tpu.data import graphs as JG
from upgdm_tpu.eval import ews_classic as JE
from upgdm_tpu.ops.graph import graphml_to_adjacency as jax_graphml
from upgdm_tpu.utils.io import load_pt as jax_load_pt
from upgdm_tpu_torch.data import bury_sim as PB
from upgdm_tpu_torch.data import generate as PGen
from upgdm_tpu_torch.data import graphs as PG
from upgdm_tpu_torch.eval import ews_classic as PE
from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
from upgdm_tpu_torch.utils.io import load_pt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
GRAPHS = REPO / "dataset/train_dataset_graph"
FAMILIES = ("erdos_renyi", "small-world", "barabasi_albert", "static_power_law", "K_Regular")


def _same_draws(jax_fn, port_fn, state):
    """Both generators from the same global ``random`` state: their graphs
    and the state they leave behind."""
    random.seed(state)
    want = jax_fn()
    after = random.getstate()
    random.seed(state)
    got = port_fn()
    assert random.getstate() == after
    return got, want


@pytest.mark.parametrize("case", [f"gen_graph:{f}" for f in FAMILIES]
                         + ["generate_network:ER", "generate_network:BA", "generate_network:WS"])
def test_generators_are_networkx_bit_for_bit(case):
    kind, name = case.split(":")
    for s in range(6):
        if kind == "gen_graph":
            lo, hi = (20, 40) if s % 2 else (12, 16)
            got, want = _same_draws(lambda: JG.gen_graph(name, lo, hi, rng=random.Random(s)),
                                    lambda: PG.gen_graph(name, lo, hi, rng=random.Random(s)),
                                    100 + s)
            want = nx.to_numpy_array(want, dtype=np.float32)
        else:
            kw = {"ER": dict(p=0.15), "BA": dict(m=3), "WS": dict(k=6, p=0.3)}[name]
            n = 30 + 7 * s
            seed = s if s < 5 else None  # None: the global random, as networkx
            got, want = _same_draws(lambda: JG.generate_network(name, n, seed=seed, **kw),
                                    lambda: PG.generate_network(name, n, seed=seed, **kw), s)
            want = want.adj
        assert got.adj.dtype == np.float32
        np.testing.assert_array_equal(got.adj, want)
        assert (np.diag(got.adj) == 0).all()


TARGETS = ("LCC", "global_CC", "average_CC", "natural_connectivity", "global_efficiency",
           "density")


@pytest.mark.parametrize("target", TARGETS)
def test_graph_properties_match_jax(target):
    """Tracked graphs of each size, whole and under a node mask that cuts
    them apart, and a graph with a self loop: rtol 1e-12."""
    rng = np.random.default_rng(0)
    adjs = [graphml_to_adjacency(GRAPHS / f"{fam}_{n}_1.graphml").adj
            for fam, n in (("barabasi_albert", 30), ("erdos_renyi", 50), ("small-world", 70),
                           ("barabasi_albert", 100))]
    loop = adjs[0].copy()
    loop[3, 3] = 1.0
    for adj in adjs + [loop]:
        for mask in (np.ones(len(adj), bool), rng.random(len(adj)) < 0.4):
            want = JG.graph_properties(adj, mask, target)
            got = PG.graph_properties(adj, mask, target)
            assert isinstance(got, float)
            assert got == pytest.approx(want, rel=1e-12, abs=0), (target, got, want)
    with pytest.raises(ValueError):
        PG.graph_properties(adjs[0], np.ones(30, bool), "diameter")


def test_save_graphml_reads_back(tmp_path):
    random.seed(3)
    g = PG.gen_graph("small-world", 25, 25, rng=random.Random(1))
    path = tmp_path / "sub" / "g.graphml"
    PG.save_graphml(g, path)
    back = nx.read_graphml(path)
    assert list(back.nodes) == [str(i) for i in range(25)]
    np.testing.assert_array_equal(nx.to_numpy_array(back, dtype=np.float32), g.adj)
    np.testing.assert_array_equal(graphml_to_adjacency(path).adj, g.adj)
    np.testing.assert_array_equal(jax_graphml(path).adj, g.adj)


def test_graph_library_equals_jax_in_one_process(tmp_path):
    """The library layout, and within one process (the same string hashes)
    the same graphs as the JAX package's."""
    kw = dict(sizes=(16, 24), seeds=range(2))
    random.seed(5)
    JG.generate_graph_library(tmp_path / "jax", **kw)
    random.seed(5)
    PG.generate_graph_library(tmp_path / "port", **kw)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(f"{t}_{n}_{s}.graphml" for t in ("erdos_renyi", "small-world",
                                                            "barabasi_albert")
                           for n in (16, 24) for s in range(2))
    for name in names:
        got = graphml_to_adjacency(tmp_path / "port" / name).adj
        np.testing.assert_array_equal(got, jax_graphml(tmp_path / "jax" / name).adj)
        assert got.shape[0] == int(name.split("_")[-2])
        assert PG.graph_properties(got, np.ones(len(got), bool), "LCC") == len(got)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*.pt"))


def _cross_load(a, b):
    """Each package loads the other's records: the same keys, shapes and types."""
    for rel in _tree(a):
        mine, theirs = load_pt(Path(b) / rel), jax_load_pt(Path(a) / rel)
        assert set(mine) == set(theirs)
        for k in mine:
            assert mine[k].shape == theirs[k].shape and mine[k].dtype == theirs[k].dtype


def test_cli_writes_the_jax_layout(tmp_path):
    """``main`` for SLBP and SIS at a tiny total time on the CPU: the file
    trees equal the JAX CLI's, and each package loads the other's records."""
    gdir = tmp_path / "graphs"
    gdir.mkdir()
    for name in ("barabasi_albert_30_0", "erdos_renyi_30_1"):
        (gdir / f"{name}.graphml").write_bytes((GRAPHS / f"{name}.graphml").read_bytes())
    runs = (["SLBP", "--total-time", "20", "--burn-time", "1", "--save-every", "2", "--trend",
             "increase"],
            ["SIS", "--total-time", "3", "--burn-time", "0.5", "--graph-dir", str(gdir),
             "--trend", "increase"],
            ["biomass", "--total-time", "2", "--burn-time", "0.5", "--graph-dir", str(gdir),
             "--graph-filter", "erdos*", "--constant", "1.5"])
    for args in runs:
        sub = args[0] + args[-1]
        JGen.main(args + ["--out-dir", str(tmp_path / "jax" / sub)])
        PGen.main(args + ["--out-dir", str(tmp_path / "port" / sub), "--device", "cpu"])
        assert _tree(tmp_path / "port" / sub) == _tree(tmp_path / "jax" / sub)
        assert _tree(tmp_path / "port" / sub)
        _cross_load(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    assert _tree(tmp_path / "port" / "SLBPincrease") == [
        f"SLBP_dynamic_total_time_20.0_N_increase/SLBP_dynamic_D_{d}.pt" for d in (1e-05, 5e-06)]
    rec = load_pt(tmp_path / "port/SISincrease/barabasi_albert_30_0/SIS_dynamic_increase.pt")
    assert rec["ys_dynamic"].shape == (30, 30) and np.isfinite(rec["ys_dynamic"]).all()
    assert (tmp_path / "port/biomass1.5/erdos_renyi_30_1/biomass_dynamic_contant.pt").exists()


def test_dataset_drivers_return_the_jax_paths(tmp_path):
    kw = dict(total_times=(4.0,), d_values=(1e-5,), burn_time=0.5, trends=("increase",))
    want = JGen.generate_slbp_dataset(tmp_path / "j", **kw)
    got = PGen.generate_slbp_dataset(tmp_path / "p", device="cpu", **kw)
    assert [p.relative_to(tmp_path / "p") for p in got] == \
        [p.relative_to(tmp_path / "j") for p in want]
    rec, jrec = load_pt(got[0]), jax_load_pt(want[0])
    np.testing.assert_array_equal(rec["N_values"], jrec["N_values"])
    np.testing.assert_array_equal(rec["ts_dynamic"], jrec["ts_dynamic"])


def test_cli_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PGen.main(["SLBP", "--out-dir", str(tmp_path), "--total-time", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PGen.generate_network_dataset("SIS", GRAPHS, tmp_path, graph_filter="nothing")
    assert not list(tmp_path.iterdir())


def test_cli_help_runs_without_jax_networkx_pandas():
    code = ("import sys, runpy; sys.argv = ['generate', '--help']\n"
            "try:\n    runpy.run_module('upgdm_tpu_torch.data.generate', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'networkx', 'pandas', 'upgdm_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True)
    assert "--device" in out.stdout and out.stdout.strip().endswith("[]"), out.stdout


def test_bury_corpus_is_jax_bit_for_bit(tmp_path):
    for form in ("fold", "transcritical", "pitchfork"):
        for forced in (True, False):
            a = JB.simulate_bury_series(form, forced, 150, np.random.default_rng(4))
            b = PB.simulate_bury_series(form, forced, 150, np.random.default_rng(4))
            np.testing.assert_array_equal(b, a)
    want = JB.generate_bury_training_corpus(tmp_path / "j", n_series=8, n_points=120, seed=3)
    got = PB.generate_bury_training_corpus(tmp_path / "p", n_series=8, n_points=120, seed=3)
    assert [p.relative_to(tmp_path / "p") for p in got] == \
        [p.relative_to(tmp_path / "j") for p in want]
    for g, w in zip(got, want):
        mine, theirs = load_pt(g), jax_load_pt(w)
        assert mine.keys() == theirs.keys() and mine["data_type"] == theirs["data_type"]
        np.testing.assert_array_equal(mine["ys_dynamic"], theirs["ys_dynamic"])
        np.testing.assert_array_equal(mine["ts_dynamic"], theirs["ts_dynamic"])
    # resume: existing files are kept, the corpus is the same
    again = PB.generate_bury_training_corpus(tmp_path / "p", n_series=8, n_points=120, seed=3)
    assert again == got


def _residuals(n=200, seed=2):
    t, y = _series(n, seed)
    return t, PE.detrend(y, method="Gaussian")


@pytest.mark.parametrize("fn", ["gaussian_smooth", "lowess_smooth", "detrend", "rolling_ar1",
                                "_sample_entropy", "rolling_sample_entropy",
                                "compute_variance_trend", "normalize_by_head_mean"])
def test_ews_classic_functions_are_jax_bit_for_bit(fn):
    t, y = _series(90, 5)
    _, r = _residuals()
    y_nan = y.copy()
    y_nan[[4, 40]] = np.nan
    calls = {
        "gaussian_smooth": [(y, 0.2), (y, 7.0)],
        "lowess_smooth": [(y, 0.2), (y, 0.3, t ** 1.1, 1), (y + 5.0 * (t == 30), 0.25)],
        "detrend": [(y, m) for m in ("Gaussian", "Lowess", "none")] + [(y_nan, "Gaussian")],
        "rolling_ar1": [(r, 0.5), (r, 30)],
        "_sample_entropy": [(r[:60],), (r[:60], 2, 0.3), (np.zeros(10),)],
        "rolling_sample_entropy": [(r[:80], 0.5)],
        "compute_variance_trend": [(t, y), (t, y_nan, 20, 5, False), (t[:3], y[:3])],
        "normalize_by_head_mean": [(y,), (y_nan, 10), (np.zeros(5),)],
    }[fn]
    for args in calls:
        want, got = getattr(JE, fn)(*args), getattr(PE, fn)(*args)
        pairs = zip(got, want) if fn == "compute_variance_trend" else [(got, want)]
        for g, w in pairs:
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        PE.detrend(y, method="spline")


def test_rolling_variance_is_pandas():
    """pandas' rolling(w).var() (ddof 1, NaN head, NaN where a window holds a
    NaN) at rtol 1e-12, and JAX's rolling_variance (which is pandas')."""
    rng = np.random.default_rng(7)
    for n, rw in ((100, 0.5), (600, 0.3), (57, 10), (5, 0.9)):
        r = rng.normal(size=n).cumsum() * 0.1 + 3.0
        if n == 600:
            r[[10, 300]] = np.nan
        w = PE._window_size(n, rw)
        want = pd.Series(r).rolling(window=w).var().to_numpy()
        got = PE.rolling_variance(r, rw)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
        np.testing.assert_allclose(got, JE.rolling_variance(r, rw), rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("method", ["Gaussian", "Lowess"])
def test_compute_classic_ews_matches_jax_and_the_goldens(method):
    """The three indicators as arrays beside their times, equal to JAX's
    Series (the variance at rtol 1e-12), and the fixed-seed vectors of
    tests/test_ews_goldens.py at their rtol 1e-9."""
    t, y = _series(n=100, seed=7 if method == "Gaussian" else 8)
    kw = dict(method="Gaussian", rolling_window=0.5) if method == "Gaussian" else \
        dict(method="Lowess", span=0.25, rolling_window=0.4)
    got = PE.compute_classic_ews(t, y, **kw)
    want = JE.compute_classic_ews(t, y, **kw)
    assert set(got) == {"times", "variance", "ar1", "sample-entropy-1"}
    for key in ("variance", "ar1", "sample-entropy-1"):
        np.testing.assert_array_equal(want[key].index.to_numpy(dtype=float), got["times"])
        if key == "variance":
            np.testing.assert_allclose(got[key], want[key].to_numpy(), rtol=1e-12,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(got[key], want[key].to_numpy())
    if method == "Gaussian":
        v = [got[k][i] for k in ("variance", "ar1", "sample-entropy-1") for i in (49, -1)]
        np.testing.assert_allclose(v, GOLDEN_CLASSIC_EWS, rtol=1e-9)
        assert np.isnan(got["variance"][47])
    else:
        v = [got[k][-1] for k in ("variance", "ar1", "sample-entropy-1")]
        np.testing.assert_allclose(v, GOLDEN_CLASSIC_EWS_LOWESS, rtol=1e-9)
