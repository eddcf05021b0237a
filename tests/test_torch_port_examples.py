"""The port's experiment drivers (``upgdm_tpu_torch/examples/``) against the
JAX package's drivers of ``examples/`` (CPU).

Every driver answers ``--help``, takes ``--device`` and writes its own
``demo_*_torch`` tree by default; the drivers' tables equal JAX's; the window
builders equal JAX's bit for bit on records written by JAX's simulator; the
real-data demo's empirical record equals the tracked one; the SLBP demo's
scan over a copy of ``demo_artifacts`` gives the recorded g(x) block within
the port's g(x) bar (``tests/test_torch_port_slbp.py``), and a tiny run writes
JAX's summary keys; the real-data, network and Fig-1 demos at tiny depth write
the tracked trees' files; the network demo's salted-hash graphs equal JAX's
under one fixed ``PYTHONHASHSEED``; ``visualization_evalution``'s layout is
networkx's.
"""
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import artifact_names
from upgdm_tpu_torch.utils.io import load_pt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
DRIVERS = ("slbp_demo", "fig1_demo", "fig1_arm_driver", "network_stats_demo",
           "real_data_demo", "n100_scale_demo", "paper_figures_demo", "reference_zoo",
           "run_seed_study_round5", "run_fig9_round5", "run_dts_neuronal_round5")
GX_BAR = 1e-3  # the port's bar on the demo record's g(x) block (test_torch_port_slbp.py)


def port(name):
    return importlib.import_module(f"upgdm_tpu_torch.examples.{name}")


def jax_driver(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def csv_shape(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], len(lines)


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_help_and_device(name, capsys):
    with pytest.raises(SystemExit) as exc:
        port(name).main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("name", [d for d in DRIVERS if hasattr(port(d), "DEFAULT_OUT")])
def test_default_output_is_an_untracked_tree(name):
    out = Path(port(name).DEFAULT_OUT)
    assert out.name.startswith("demo_") and out.name.endswith("_torch")
    assert "demo_*_torch/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("driver,table", [
    ("fig1_demo", "SYSTEMS"), ("fig1_demo", "GRAPH"),
    ("n100_scale_demo", "GRAPH"), ("n100_scale_demo", "W"), ("n100_scale_demo", "P"),
    ("paper_figures_demo", "SLBP_TOTALS"), ("paper_figures_demo", "SLBP_MAIN_TOTAL"),
    ("paper_figures_demo", "SLBP_D_VALUES"), ("paper_figures_demo", "SLBP_MAIN_D"),
    ("paper_figures_demo", "FIG5_TIME_ROWS"), ("paper_figures_demo", "SENS_LENS"),
    ("paper_figures_demo", "CONTANT_SPECS"), ("paper_figures_demo", "GRAPHS"),
    ("paper_figures_demo", "SYSTEMS"), ("paper_figures_demo", "SLBP_NET"),
    ("paper_figures_demo", "stable_seed"), ("paper_figures_demo", "_real_names"),
])
def test_driver_tables_match_jax(driver, table):
    got, want = getattr(port(driver), table), getattr(jax_driver(driver), table)
    if callable(want):
        args = [("200000.0", "increase", "1e-05"), ("D_0.001",), ("SIS", "erdos_renyi_50_0")]
        got = [got(*a) for a in args] if table == "stable_seed" else got()
        want = [want(*a) for a in args] if table == "stable_seed" else want()
    assert got == want


# ---- window builders on records written by JAX's simulator -----------------------------------

@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    from upgdm_tpu.data.sde import simulate_network_system, simulate_slbp
    from upgdm_tpu.ops.graph import graphml_to_adjacency
    from upgdm_tpu.utils.io import save_pt

    out = tmp_path_factory.mktemp("records")
    adj = graphml_to_adjacency(REPO / "demo_n100/test_graph/barabasi_albert_100_0.graphml").adj
    rec = simulate_network_system(
        "SIS", adj, trend="increase", total_time=55.0, burn_time=1.0, dt=0.01,
        save_every=10, seed=7, control_range=(1e-4, 0.075), base_params={"d": 0.5}, eta=1e-4)
    save_pt(rec, out / "sis100.pt")
    slbp = []
    for trend in ("increase", "decrease"):
        r = simulate_slbp(params={"D": 1e-5}, trend=trend, total_time=50000.0,
                          burn_time=10.0, dt=0.1, seed=1)
        save_pt(r, out / f"slbp_{trend}.pt")
        slbp.append(out / f"slbp_{trend}.pt")
    return out / "sis100.pt", slbp


@pytest.mark.parametrize("stride", [50, 100])
def test_n100_build_windows_match_jax(jax_records, stride):
    sis, _ = jax_records
    got = port("n100_scale_demo").build_windows(sis, stride)
    want = jax_driver("n100_scale_demo").build_windows(sis, stride)
    assert got[0].shape[1:] == (100, 400, 1) and len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("w,p,stride", [(20, 20, None), (10, 15, 3)])
def test_paper_slbp_windows_match_jax(jax_records, w, p, stride):
    _, slbp = jax_records
    got = port("paper_figures_demo")._slbp_windows(slbp, w, p, stride)
    want = jax_driver("paper_figures_demo")._slbp_windows(slbp, w, p, stride)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---- the demos ---------------------------------------------------------------------------------

def test_empirical_record_equals_the_tracked_one(tmp_path):
    R = port("real_data_demo")
    R.build_empirical_record(tmp_path / "rec.pt")
    got, want = load_pt(tmp_path / "rec.pt"), load_pt(REPO / "demo_real/data/slbp_empirical_demo.pt")
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.fixture
def small_n_z(monkeypatch):
    """Models load with 2 samples: the sampling arm's cost on the CPU."""
    from upgdm_tpu_torch.eval import uncertainty as U

    real = U.load_model_from_dir

    def load(path, device=None, infer_params=None, **kw):
        return real(path, device=device,
                    infer_params=dict(infer_params or {}, n_z_samples=2), **kw)

    monkeypatch.setattr(U, "load_model_from_dir", load)


def test_slbp_demo_scan_reproduces_the_gx_record(tmp_path, small_n_z):
    """``--stage scan`` over a copy of ``demo_artifacts``: 191 windows, the
    recorded transition, the g(x) block within the port's bar and the
    record's keys (the sampling arm at 2 samples here)."""
    out = tmp_path / "demo"
    shutil.copytree(REPO / "demo_artifacts", out,
                    ignore=shutil.ignore_patterns("*.png", "summary.json"))
    record = json.loads((REPO / "demo_artifacts/summary.json").read_text())
    summary = port("slbp_demo").main(["--out-dir", str(out), "--stage", "scan",
                                      "--device", "cpu"])
    assert json.loads((out / "summary.json").read_text()).keys() == record.keys()
    assert summary["n_windows"] == record["n_windows"] == 191
    assert summary["transition_time_state"] == record["transition_time_state"]
    assert summary["gx_mpv"].keys() == record["gx_mpv"].keys()
    assert summary["sampling_mpv"].keys() == record["sampling_mpv"].keys()
    for k in ("baseline_mpv", "pre_transition_drop_percent", "global_drop_percent"):
        assert abs(summary["gx_mpv"][k] / record["gx_mpv"][k] - 1) <= GX_BAR, k
    assert summary["gx_mpv"]["global_min_mpv_time"] == record["gx_mpv"]["global_min_mpv_time"]


def test_slbp_demo_tiny_end_to_end(tmp_path):
    """The three stages and the scan at tiny width on the tracked trajectory
    (the data stage is skipped when ``slbp_data`` exists), then the data
    stage alone at a short total time against JAX's file tree."""
    out = tmp_path / "port"
    shutil.copytree(REPO / "demo_artifacts/slbp_data", out / "slbp_data")
    S = port("slbp_demo")
    S.main(["--out-dir", str(out), "--windows", "60", "--pred-len", "20", "--epochs", "1",
            "--n-z-samples", "2", "--device", "cpu"])
    record = json.loads((REPO / "demo_artifacts/summary.json").read_text())
    got = json.loads((out / "summary.json").read_text())
    assert got.keys() == record.keys()
    assert got["sampling_mpv"].keys() == record["sampling_mpv"].keys()
    for stage in ("pre_model_F", "pre_model_G", "nsdiff/trained_model", "model"):
        assert (out / stage / "model_trained").exists(), stage
    for k in ("jax", "port_data"):
        argv = ["--out-dir", str(tmp_path / k), "--stage", "data", "--total-time", "2000"]
        if k == "jax":
            jax_driver("slbp_demo").main(argv)
        else:
            S.main(argv + ["--device", "cpu"])
    assert artifact_names(tmp_path / "port_data") == artifact_names(tmp_path / "jax")
    rel = artifact_names(tmp_path / "jax")[0]
    want, got = load_pt(tmp_path / "jax" / rel), load_pt(tmp_path / "port_data" / rel)
    assert {k: np.shape(v) for k, v in got.items()} == {k: np.shape(v) for k, v in want.items()}


@pytest.mark.parametrize("render", [True, False], ids=["matplotlib", "no_matplotlib"])
def test_real_data_demo_tiny_writes_the_tracked_files(tmp_path, monkeypatch, render):
    """Without matplotlib (the card's machine) the same tables, no image."""
    from upgdm_tpu_torch.figures import common

    monkeypatch.setattr(common, "can_render", lambda: render)
    out = tmp_path / "real"
    port("real_data_demo").main(["--out-dir", str(out), "--epochs", "1", "--device", "cpu"])
    assert bool(list(out.rglob("*.png"))) == render
    tracked = artifact_names(REPO / "demo_real")
    assert artifact_names(out, like=REPO / "demo_real") == tracked
    csv = "figures/slbp_empirical_demo/slbp_empirical_demo_real_data_ews_signals.csv"
    assert csv_shape(out / csv) == csv_shape(REPO / "demo_real" / csv)
    rows = {k: [r for r in (root / csv).read_text().splitlines()
                if ",trajectory," in r or ",variance," in r or ",ar1," in r]
            for k, root in (("port", out), ("tracked", REPO / "demo_real"))}
    assert rows["port"] == rows["tracked"] and len(rows["port"]) > 100


@pytest.mark.parametrize("render", [True, False], ids=["matplotlib", "no_matplotlib"])
def test_network_demo_tiny_writes_the_tracked_tables(tmp_path, monkeypatch, render):
    """Without matplotlib the relation tables are still written, no image."""
    from upgdm_tpu_torch.figures import mpv_collapse

    monkeypatch.setattr(mpv_collapse, "can_render", lambda: render)
    out = tmp_path / "net"
    port("network_stats_demo").main(["--out-dir", str(out), "--total-time", "60",
                                     "--windows", "60", "--pred-len", "20", "--epochs", "1",
                                     "--device", "cpu"])
    tracked = artifact_names(REPO / "demo_network/statistics")
    assert artifact_names(out, like=REPO / "demo_network") == [
        f"statistics/{rel}" for rel in tracked]
    for rel in tracked:
        if rel.endswith(".csv") and "samples" not in rel:
            assert csv_shape(out / "statistics" / rel)[0] == csv_shape(
                REPO / "demo_network/statistics" / rel)[0], rel
    assert csv_shape(out / "statistics/mpv_collapse_samples.csv") == csv_shape(
        REPO / "demo_network/statistics/mpv_collapse_samples.csv")
    pngs = list((out / "statistics").rglob("*.png"))
    assert (len(pngs) >= 2) == render


def test_network_demo_graphs_under_a_fixed_hash_seed(tmp_path):
    """The salted ``hash(g_type)`` seeds: in one process under
    ``PYTHONHASHSEED=0``, the port's graphs equal those the JAX driver's
    expression draws (networkx), global ``random`` seeded alike."""
    code = (
        "import random, numpy as np, networkx as nx\n"
        "from upgdm_tpu.data.graphs import gen_graph as jgen\n"
        "from upgdm_tpu_torch.data.graphs import gen_graph as pgen\n"
        "from upgdm_tpu_torch.examples.network_stats_demo import TOPOLOGIES, graph_rng\n"
        "for g_type, n, seed in TOPOLOGIES:\n"
        "    random.seed(1)\n"
        "    j = jgen(g_type, n, n, rng=random.Random(seed + hash(g_type) % 1000))\n"
        "    random.seed(1)\n"
        "    p = pgen(g_type, n, n, rng=graph_rng(g_type, seed))\n"
        "    ja = nx.to_numpy_array(j, nodelist=sorted(j.nodes)) if hasattr(j, 'nodes') "
        "else np.asarray(j.adj)\n"
        "    assert np.array_equal(ja, np.asarray(p.adj)), g_type\n"
        "print('equal', hash('barabasi_albert') % 1000)\n"
    )
    env = dict(os.environ, PYTHONHASHSEED="0")
    runs = [subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                           capture_output=True, timeout=300) for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    assert runs[0].stdout == runs[1].stdout and runs[0].stdout.startswith("equal")


def test_fig1_demo_tiny_writes_the_tracked_files(tmp_path):
    out = tmp_path / "fig1"
    port("fig1_demo").main(["--out-dir", str(out), "--windows", "60", "--pred-len", "20",
                            "--epochs", "1", "--n-z-samples", "2", "--device", "cpu"])
    tracked = artifact_names(REPO / "demo_fig1")
    assert artifact_names(out, like=REPO / "demo_fig1") == tracked
    for rel in tracked:
        if rel.endswith(".pt") and "spdata" in rel:
            want, rec = load_pt(REPO / "demo_fig1" / rel), load_pt(out / rel)
            assert {k: np.shape(v) for k, v in rec.items()} == {
                k: np.shape(v) for k, v in want.items()}, rel
    assert (out / "figures/fig1_model_compare_increase.png").exists()


# ---- visualization_evalution -------------------------------------------------------------------

def _graphs():
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(0)
    return {
        "ba20": nx.to_numpy_array(nx.barabasi_albert_graph(20, 2, seed=1)),
        "weighted_asymmetric": (rng.random((15, 15)) < 0.2) * rng.integers(1, 4, (15, 15)),
        "two_components": nx.to_numpy_array(nx.disjoint_union(nx.path_graph(5),
                                                              nx.cycle_graph(6))),
    }


@pytest.mark.parametrize("graph", ["ba20", "weighted_asymmetric", "two_components"])
def test_kamada_kawai_layout_is_networkx(graph, tmp_path):
    nx = pytest.importorskip("networkx")
    from upgdm_tpu_torch.utils.data_visualization import (
        kamada_kawai_layout, visualization_evalution,
    )

    adj = np.asarray(_graphs()[graph], np.float64)
    want = nx.kamada_kawai_layout(nx.from_numpy_array(adj))
    want = np.array([want[i] for i in range(len(adj))])
    np.testing.assert_allclose(kamada_kawai_layout(adj), want, rtol=0, atol=1e-6)
    if graph == "ba20":
        fig = visualization_evalution(np.zeros(len(adj)), adj, np.ones(len(adj)),
                                      save_path=tmp_path / "v.png")
        assert len(fig.axes) == 4 and (tmp_path / "v.png").stat().st_size > 0
