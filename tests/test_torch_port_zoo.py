"""The port's reference zoo and seed study (``upgdm_tpu_torch/examples/``)
against the JAX package's drivers of ``examples/`` (CPU).

The tables, ``stable_seed`` and the ``--tiny`` overrides are equal; the
pandas-free ``summarize`` reproduces the tracked ``corpus_summary.json`` byte
for byte and equals JAX's pandas reduction on synthetic CSVs (NaN and empty
cells, booleans read as pandas reads them, skip reasons with tied counts), as
does the seed study's table; the window builders equal JAX's bit for bit on
records written by JAX's simulator; ``gen_data`` at the tiny corpus writes
JAX's file tree (SDE noise differs between the packages: Philox against
``jax.random``, so records are compared by keys, shapes and dtypes); the
figure job selection, the manifest, the stall watchdog and the real-data
chain at tiny dims behave as JAX's.
"""
import copy
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from upgdm_tpu_torch.examples import frame
from upgdm_tpu_torch.examples import reference_zoo as P
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))
import reference_zoo as Z  # noqa: E402

TABLES = ("CORPUS_GRAPHS", "TRENDS", "SYSTEMS", "TRAINED_ON_TOPOLOGY", "REF_NET",
          "SLBP_TOTAL", "SLBP_D", "FIG5_TIME_ROWS", "FIG59_D_VALUES", "CONTANT_SPECS",
          "COMPARE_NETS", "COMPARE_TRAIN", "REAL_DATA_NAMES", "N_BURY_SERIES",
          "BURY_MAX_MODELS")
SAVED = ("CORPUS_GRAPHS", "REF_NET", "SLBP_TOTAL", "N_BURY_SERIES", "BURY_MAX_MODELS",
         "COMPARE_NETS", "COMPARE_TRAIN")
SAMPLES = REPO / "demo_zoo/mpv_collapse/mpv_collapse_samples.csv"


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tables_restored():
    """Both zoos' module tables as they were, whatever the test changes."""
    saved = {m: {k: copy.deepcopy(getattr(m, k)) for k in SAVED} for m in (Z, P)}
    yield
    for m, tables in saved.items():
        for k, v in tables.items():
            if isinstance(v, dict) and k.startswith("COMPARE"):
                getattr(m, k).clear()
                getattr(m, k).update(v)
            else:
                setattr(m, k, v)


def _jax_tiny(monkeypatch, tmp_path):
    """The JAX zoo's tables after ``main`` with ``--tiny`` (stages stubbed)."""
    seen = {}
    monkeypatch.setattr(Z, "gen_data", lambda out, fig1_only=False: seen.update(
        {k: copy.deepcopy(getattr(Z, k)) for k in TABLES}))
    monkeypatch.setattr(sys, "argv", ["reference_zoo.py", "--tiny", "--stage", "data",
                                      "--out-dir", str(tmp_path)])
    Z.main()
    return seen


@pytest.mark.parametrize("name", TABLES + ("tiny", "stable_seed", "graph_lib"))
def test_zoo_tables_match_jax(name, monkeypatch, tmp_path, tables_restored):
    if name == "stable_seed":
        for parts in (("bury",), ("compare", "TMDM", "SIS"), ("400000.0", "increase", "1e-05"),
                      ("NsDiff_machine/NsDiff", "dataset_w200p200st100"), ("real_sim",)):
            assert P.stable_seed(*parts) == Z.stable_seed(*parts)
    elif name == "graph_lib":
        assert P.GRAPH_LIB == Z.GRAPH_LIB
        assert all((P.GRAPH_LIB / f"{g}.graphml").exists() for g in P.CORPUS_GRAPHS)
    elif name == "tiny":
        want = _jax_tiny(monkeypatch, tmp_path)
        P.apply_tiny()
        assert {k: getattr(P, k) for k in TABLES} == want
    else:
        assert getattr(P, name) == getattr(Z, name)


# ---- summarize without pandas ------------------------------------------------------------

def test_summarize_reproduces_the_tracked_corpus_summary(tmp_path):
    (tmp_path / "mpv_collapse").mkdir()
    shutil.copy(SAMPLES, tmp_path / "mpv_collapse")
    P.summarize(tmp_path)
    got = (tmp_path / "mpv_collapse/corpus_summary.json").read_bytes()
    assert got == (REPO / "demo_zoo/mpv_collapse/corpus_summary.json").read_bytes()


HEADER = ("dynamic_type,trend,is_transition,skip_reason,lead_time,"
          "pre_transition_drop_percent,global_drop_percent\n")
SYNTHETIC = {
    # booleans with missing cells (pandas: an object column of True/False/NaN),
    # tied skip reasons, a lead cell that is not a number, inf, a missing key
    "mixed": [
        "SIS,increase,True,,1.5,10.25,20",
        "SIS,increase,False,b,,,",
        "SIS,decrease,True,,abc,5,",
        "SIS,decrease,False,a,2,,",
        "SIS,decrease,,a,3,,",
        "SIS,decrease,False,b,2,,",
        "SIS,decrease,False,,7,1,1",
        "biomass,increase,True,,-1,1e3,inf",
        ",increase,True,,4,1,1",
        "neuronal,,True,,4,1,1",
        "neuronal,decrease,True,,0.30000000000000004,-2.5,3.3333333333333335",
        "neuronal,decrease,True,,-0.1,12.345678901234567,0",
    ],
    # clean booleans, every skip reason empty: skip_reason is read as floats
    "clean": [
        "SIS,increase,True,,0.5,1,2",
        "SIS,increase,True,,-0.5,3,4",
        "biomass,decrease,False,,,,",
        "biomass,decrease,True,,12.5,40.125,41",
    ],
    # no transition at all: every statistic None, reasons counted
    "none": [
        "SIS,increase,False,too_few_pre_transition_mpv_points,,,",
        "SIS,increase,False,too_few_pre_transition_mpv_points,,,",
        "SIS,decrease,False,mpv_error:x,,,",
        "SIS,decrease,False,,,,",
    ],
    # numbers where the flag is 1/0 (pandas compares 1 == True)
    "numeric_flag": [
        "SIS,increase,1,,0.25,1,2",
        "SIS,increase,0,r,,,",
        "biomass,increase,1,,-3,5,6",
    ],
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_summarize_matches_pandas_on_synthetic_csvs(case, tmp_path):
    out = {}
    for mod in (Z, P):
        root = tmp_path / mod.__name__.replace(".", "_")
        (root / "mpv_collapse").mkdir(parents=True)
        (root / "mpv_collapse/mpv_collapse_samples.csv").write_text(
            HEADER + "\n".join(SYNTHETIC[case]) + "\n")
        mod.summarize(root)
        out[mod] = (root / "mpv_collapse/corpus_summary.json").read_text()
    assert out[P] == out[Z]


def test_frame_parses_numbers_as_pandas():
    """``parse_float`` is pandas' C parser, not Python's correctly rounded
    ``float``: on the tracked samples CSV every cell is pandas' value."""
    import pandas as pd

    want = pd.read_csv(SAMPLES)
    got = frame.read_csv(SAMPLES)
    assert list(got) == list(want.columns)
    for col in want.columns:
        for w, g in zip(want[col].tolist(), got[col]):
            if frame.is_na(w) if not isinstance(w, str) else False:
                assert frame.is_na(g), col
                continue
            assert type(g) is type(w) or isinstance(w, float), (col, w, g)
            assert g == w, (col, w, g)
    rng = np.random.default_rng(0)
    texts = [repr(float(v)) for v in rng.normal(size=500) * 10.0 ** rng.integers(-20, 20, 500)]
    texts += [f"{v:.{k}f}" for v, k in zip(rng.normal(size=500), rng.integers(1, 24, 500))]
    import io

    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"].tolist()
    assert [frame.parse_float(t)[0] for t in texts] == want
    assert any(float(t) != w for t, w in zip(texts, want)), "no case where float() differs"


def test_seed_study_row_matches_pandas(tmp_path):
    J = _load_example("run_seed_study_round5")
    from upgdm_tpu_torch.examples import run_seed_study_round5 as S

    (tmp_path / "mpv_collapse_samples.csv").write_text(
        "skip_reason,lead_time,pre_transition_drop_percent\n"
        ",1.5,10\n,-2,20.5\nx,3,\n,abc,7\n,,\n,0.1,1e-3\n")
    thr = ("threshold,dynamic_type,lead_time\n0.1,SIS,2.5\n0.1,SIS,-1\n0.30000000000000004,SIS,9\n"
           "0.1,SIS,\n0.1000000001,SIS,4\n")
    (tmp_path / "mpv_drop_threshold_lead_time.csv").write_text(thr)
    assert S.seed_row(7, tmp_path) == J.seed_row(7, tmp_path)
    # no threshold table; no valid file at all (NaN statistics)
    (tmp_path / "mpv_drop_threshold_lead_time.csv").unlink()
    assert S.seed_row(7, tmp_path) == J.seed_row(7, tmp_path)
    (tmp_path / "mpv_collapse_samples.csv").write_text(
        "skip_reason,lead_time,pre_transition_drop_percent\nx,1,2\n")
    got, want = S.seed_row(1, tmp_path), J.seed_row(1, tmp_path)
    assert json.dumps(got) == json.dumps(want)


# ---- window builders and the data stage -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """A small corpus written by JAX's simulator: SIS, biomass and neuronal
    on two library graphs, both trends, and two SLBP records."""
    from upgdm_tpu.data.sde import simulate_network_system, simulate_slbp
    from upgdm_tpu.figures.common import dynamics_filename, slbp_source_path
    from upgdm_tpu.ops.graph import graphml_to_adjacency
    from upgdm_tpu.utils.io import save_pt

    out = tmp_path_factory.mktemp("corpus")
    graphs = ["barabasi_albert_30_0", "erdos_renyi_50_0"]
    totals = {"SIS": (40.0, 0.01, 10), "biomass": (300.0, 0.1, 1), "neuronal": (300.0, 0.1, 1)}
    for system, (total, dt, every) in totals.items():
        cfg = Z.SYSTEMS[system]
        for gname in graphs:
            adj = graphml_to_adjacency(Z.GRAPH_LIB / f"{gname}.graphml").adj
            for trend in Z.TRENDS:
                rec = simulate_network_system(
                    system, adj, trend=trend, total_time=total, burn_time=2.0, dt=dt,
                    save_every=every, seed=Z.stable_seed(system, gname, trend),
                    control_range=cfg["control_range"], base_params=cfg["base_params"],
                    eta=cfg["eta"])
                save_pt(rec, out / "dataset" / f"spdata_sde_{system}" / gname
                        / dynamics_filename(system, trend))
    slbp = []
    for trend in Z.TRENDS:
        rec = simulate_slbp(params={"D": 1e-5}, trend=trend, total_time=60000.0,
                            burn_time=10.0, dt=0.1, seed=3, save_every=1)
        path = slbp_source_path(out / "dataset", "60000.0", trend, "1e-05")
        save_pt(rec, path)
        slbp.append(path)
    return out, graphs, slbp


@pytest.mark.parametrize("system,w,p,topology,max_windows,stride", [
    ("SIS", 100, 100, "barabasi_albert", 6000, None),
    ("SIS", 100, 100, "", 64, 100),
    ("biomass", 10, 10, "", 6000, None),
    ("neuronal", 10, 10, "erdos_renyi", 40, 5),
])
def test_corpus_windows_match_jax(jax_corpus, monkeypatch, system, w, p, topology,
                                  max_windows, stride):
    out, graphs, _ = jax_corpus
    for mod in (Z, P):
        monkeypatch.setattr(mod, "CORPUS_GRAPHS", graphs)
    want = Z._corpus_windows(out, system, w, p, topology, max_windows, stride)
    got = P._corpus_windows(out, system, w, p, topology, max_windows, stride)
    assert got.dtype == want.dtype and len(got) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,p,stride", [(20, 20, None), (10, 30, 7)])
def test_slbp_windows_match_jax(jax_corpus, w, p, stride):
    _, _, slbp = jax_corpus
    got = P._slbp_windows(slbp, w, p, stride)
    want = Z._slbp_windows(slbp, w, p, stride)
    assert got.shape[1:] == (w + p, 2)
    np.testing.assert_array_equal(got, want)


def test_gen_data_tiny_writes_jax_tree(tmp_path, monkeypatch, tables_restored):
    """``gen_data`` over the tiny corpus in both packages, every simulation
    cut to a short run (the same cut on both sides): the same files, the
    graphml copies byte for byte, records with JAX's keys, shapes and
    dtypes."""
    import upgdm_tpu_torch.data.sde as PS
    from upgdm_tpu.utils.io import load_pt as jload

    def cut(fn):
        def run(*args, **kw):
            fine = kw.get("dt", 0.1) < 0.1
            kw["total_time"] = min(kw["total_time"], 6.0 if fine else 60.0)
            kw["burn_time"] = min(kw.get("burn_time", 100.0), 0.5 if fine else 5.0)
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(Z, "simulate_slbp", cut(Z.simulate_slbp))
    monkeypatch.setattr(Z, "simulate_network_system", cut(Z.simulate_network_system))
    monkeypatch.setattr(PS, "simulate_slbp", cut(PS.simulate_slbp))
    monkeypatch.setattr(PS, "simulate_network_system", cut(PS.simulate_network_system))
    tiny = ["barabasi_albert_30_0", "erdos_renyi_50_0", "small-world_70_0"]
    for mod in (Z, P):
        mod.CORPUS_GRAPHS = tiny
        mod.SLBP_TOTAL = "200000.0"
    Z.gen_data(tmp_path / "jax")
    P.gen_data(tmp_path / "port", device="cpu")
    files = {k: sorted(p.relative_to(tmp_path / k) for p in (tmp_path / k).rglob("*"))
             for k in ("jax", "port")}
    assert files["port"] == files["jax"] and len(files["jax"]) > 30
    for rel in files["jax"]:
        j, p = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix == ".graphml":
            assert p.read_bytes() == j.read_bytes()
        elif rel.suffix == ".pt":
            want, got = jload(j), P.load_pt(p)
            assert sorted(got) == sorted(want), rel
            for k in want:
                assert np.shape(got[k]) == np.shape(want[k]), (rel, k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, (rel, k)
                assert np.isfinite(np.asarray(got[k])).all(), (rel, k)


# ---- job selection and helpers ---------------------------------------------------------------

def _tree_states(root):
    """Zoo trees of increasing completeness (the round-3/4 tests' steps)."""
    from upgdm_tpu.figures.common import slbp_source_path

    def touch(path):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"x")

    yield "empty"
    for fam in ("NsDiff", "DiffSTG", "DiffusionTS", "TMDM"):
        touch(root / "ews_results/model_compare" / fam / "SIS/model_trained")
    yield "compare"
    touch(root / "ews_results/NsDiff_pred/models/dataset__w200p1000st100")
    yield "pred"
    for m in ("NsDiff", "preg"):
        touch(root / "ews_results/NsDiff_machine" / m / "models/dataset_w200p200st100")
    touch(root / "ews_results/NsDiff_trends/models/dataset__w200p200st100")
    yield "machine"
    for trend in ("increase", "decrease"):
        for total, _f, _s in Z.FIG5_TIME_ROWS:
            for dv in Z.FIG59_D_VALUES:
                touch(slbp_source_path(root / "dataset", total, trend, dv))
        yield f"grid_{trend}"


def test_figure_jobs_match_jax(tmp_path):
    def mapped(jobs):
        return [(m.replace("upgdm_tpu.", "upgdm_tpu_torch.", 1), a) for m, a in jobs]

    seen = []
    for state in _tree_states(tmp_path):
        seen.append(state)
        assert P.figure_jobs(tmp_path) == mapped(Z.figure_jobs(tmp_path)), state
        for stage in ("figures", "all", "fig1", "slbpfigs"):
            assert (P.select_figure_jobs(tmp_path, stage)
                    == mapped(Z.select_figure_jobs(tmp_path, stage))), (state, stage)
    assert len(seen) == 6
    mods = [m for m, _ in P.figure_jobs(tmp_path)]
    assert all(m.startswith("upgdm_tpu_torch.figures.") for m in mods)
    assert mods[-1].endswith("fig1_model_compare") and mods[0].endswith("fig4_model_sensitivity")
    assert sorted(m.rsplit(".", 1)[1] for m, _ in P.select_figure_jobs(tmp_path, "slbpfigs")) \
        == ["fig5_tipping_types", "fig6_slbp_model_analysis", "fig9_smoothing"]


def test_figure_jobs_render_both_trends(tmp_path):
    jobs = P.figure_jobs(tmp_path)
    for stem in ("fig2", "fig3", "fig7"):
        assert sorted(a[a.index("--trend") + 1] for m, a in jobs if stem in m) \
            == ["decrease", "increase"], stem
    assert not any("fig1" in m or "fig4" in m for m, _ in jobs)
    assert P.select_figure_jobs(tmp_path, "fig1") == []


def test_manifest_excludes_scratch_and_self(tmp_path):
    (tmp_path / "figures").mkdir()
    (tmp_path / "figures" / "fig2.png").write_bytes(b"png")
    (tmp_path / "_scratch" / "deep").mkdir(parents=True)
    (tmp_path / "_scratch" / "deep" / "trace.json").write_text("{}")
    (tmp_path / "MANIFEST.json").write_text("[]")
    P.write_manifest(tmp_path)
    rows = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert {r["path"] for r in rows} == {"figures/fig2.png"}
    P.write_manifest(tmp_path)
    assert json.loads((tmp_path / "MANIFEST.json").read_text()) == rows
    Z.write_manifest(tmp_path)
    assert json.loads((tmp_path / "MANIFEST.json").read_text()) == rows


def test_run_until_stalled(tmp_path):
    logf = tmp_path / "r.log"
    assert P._run_until_stalled([sys.executable, "-c", "print('ok')"], logf,
                                stall_timeout=5, poll_s=1) == 0
    assert "ok" in logf.read_text()
    assert P._run_until_stalled([sys.executable, "-c", "raise SystemExit(3)"], logf,
                                stall_timeout=5, poll_s=1) == 3
    code = P._run_until_stalled(
        [sys.executable, "-c", "import time; print('start', flush=True); time.sleep(60)"],
        logf, stall_timeout=2, poll_s=1)
    assert code == "stalled" and "start" in logf.read_text()


def test_failed_render_fails_the_stage_without_a_probe(tmp_path, monkeypatch):
    """Every attempt of a render that fails is retried with nothing between
    (no accelerator probe), and the figure counts as failed; the stats stage
    raises after its attempts."""
    calls = []

    def failing(cmd, logf, stall_timeout):
        calls.append(cmd)
        logf.write_text("failed\n")
        return 1

    monkeypatch.setattr(P, "_run_until_stalled", failing)
    assert not hasattr(P, "_wait_for_tpu")
    failed = P.render_figures(tmp_path, [("upgdm_tpu_torch.figures.fig8_train_source", [])],
                              attempts=3, device="cpu")
    assert failed == 1 and len(calls) == 3
    assert calls[0][-2:] == ["--device", "cpu"] and calls[0][2] == (
        "upgdm_tpu_torch.figures.fig8_train_source")
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        P.run_stats(tmp_path, attempts=2, device="cpu")
    assert "upgdm_tpu_torch.figures.mpv_collapse" in calls[-1]
    assert calls[-1][-2:] == ["--device", "cpu"]


def test_arm_driver_skips_complete_arms(tmp_path, capsys):
    from upgdm_tpu_torch.examples import fig1_arm_driver as drv

    ews = tmp_path / "ews_results"
    arm_dir = ews / "model_compare" / "TMDM" / "SIS"
    arm_dir.mkdir(parents=True)
    (arm_dir / "SIS_dynamic_eta0.0001d0.5_increase.pt.mpv.json").write_text(json.dumps(
        {"complete": True, "n_windows_done": 7, "n_windows_total": 7,
         "fingerprint": "x", "pred_mean": [1.0] * 7, "ews": [1.0] * 7}))
    J = _load_example("fig1_arm_driver")
    for model, dataset in (("TMDM", "SIS"), ("TMDM", "neuronal"), ("NsDiff", "SIS")):
        assert (drv.arm_complete(ews, model, dataset, "increase")
                == J.arm_complete(ews, model, dataset, "increase"))
        assert drv.arm_sidecar(ews, model, dataset, "increase") == J.arm_sidecar(
            ews, model, dataset, "increase")
    assert drv.arm_complete(ews, "TMDM", "SIS", "increase") is True
    drv.main(["--ews-root", str(ews), "--source-root", str(tmp_path), "--arms", "TMDM:SIS",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "already complete, skipping" in out and "all requested arms complete" in out
    assert drv.DEFAULT_EWS_ROOT.startswith("demo_zoo_torch/")
    assert drv.DEFAULT_SOURCE_ROOT.startswith("demo_zoo_torch/")


def test_zoo_real_chain_tiny(tmp_path, tables_restored):
    """The 'real' stage at tiny dims on the CPU: the Bury-sim corpus, the
    simulation NsDiff, two Bury classifiers' probabilities and the
    real-systems composite."""
    from upgdm_tpu_torch.data.sde import simulate_slbp
    from upgdm_tpu_torch.figures.common import slbp_source_path
    from upgdm_tpu_torch.utils.io import save_pt

    P.REF_NET = dict(P.REF_NET, d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
                     p_hidden_dims=[8, 8], n_z_samples=4, parallel_sample=2)
    P.SLBP_TOTAL = "4000.0"
    P.N_BURY_SERIES = 6
    P.BURY_MAX_MODELS = 2
    rec = simulate_slbp(params={"D": 1e-05}, trend="increase", total_time=4000.0,
                        burn_time=10.0, dt=0.1, seed=0, device="cpu")
    save_pt(rec, slbp_source_path(tmp_path / "dataset", P.SLBP_TOTAL, "increase", P.SLBP_D))
    P.gen_real_data(tmp_path)
    for name in P.REAL_DATA_NAMES:
        assert (tmp_path / "dataset/real_data" / f"{name}.pt").exists()
    P.train_real_model(tmp_path, epochs=1, device="cpu")
    assert (tmp_path / "ews_results/real_data/model/simulation/model_trained").exists()
    P.run_real_chain(tmp_path, device="cpu")
    probs = list((tmp_path / "ews_results/bury_2021_ml_probs").rglob("*_bury_ml_probs.csv"))
    assert len(probs) == len(P.REAL_DATA_NAMES)
    fig = tmp_path / "figures/real_systems_figure.png"
    assert fig.exists() and fig.stat().st_size > 0

