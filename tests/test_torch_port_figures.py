"""The port's figure layer against the JAX package's (CPU).

The MPV-collapse statistics, the shared helpers and the composer's crop are
held to JAX's on seeded inputs. Each figure's loader runs in both packages
on one micro tree in the layouts the figures read, whose caches hold seeded
arrays: no model is sampled. Where a loader builds a model (fig4's targets,
fig7's prediction error, fig9's gx model) the tree holds a tiny NsDiff
checkpoint written by the port's ``save_checkpoint``, read by both packages;
the port builds it on the CPU. Then every port CLI renders its figure from a
copy of the tree with ``--device cpu``.
"""
import csv
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from upgdm_tpu.figures import mpv_collapse as JM
from upgdm_tpu_torch.figures import mpv_collapse as PM
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.ops.windows import sampling_interval_from_t, sliding_window_count
from upgdm_tpu_torch.utils.io import load_pt, save_checkpoint, save_pt, save_tensor_list
from test_torch_port_slbp import var_tol
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FIGS = ("fig1_model_compare", "fig2_graph_generalization", "fig3_dynamics_transfer",
        "fig4_model_sensitivity", "fig5_tipping_types", "fig6_slbp_model_analysis",
        "fig7_train_analysis", "fig8_train_source", "fig9_smoothing")
PORT_MODULES = [f"upgdm_tpu_torch.figures.{m}" for m in
                FIGS + ("common", "mpv_collapse", "figure_composer", "plot_bury_transitions")]
TT, DV, TRENDS = "21000.0", ("1e-05", "5e-06"), ("increase", "decrease")
W, P_LEN, S = 16, 8, 5
GRAPH = "barabasi_albert_30_0"
RTOL = 1e-7


def jmod(name):
    return importlib.import_module(f"upgdm_tpu.figures.{name}")


def pmod(name):
    return importlib.import_module(f"upgdm_tpu_torch.figures.{name}")


# -- the micro tree -------------------------------------------------------------

def _net(nf):
    return dict(dataset_nf=nf, windows=W, pred_len=P_LEN, rolling_length=4, diffusion_steps=5,
                scaler_type="StandardScaler", d_model=8, n_heads=2, e_layers=1, d_layers=1,
                d_ff=8, p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=4,
                task_model="NsDiff")


def _checkpoint(nf, seed):
    """A tiny NsDiff (random weights from a seed, a fitted scaler)."""
    model = NsDiffModel(_net(nf), seed=seed, device="cpu")
    model.scaler_fit(np.random.default_rng(seed).normal(1.0, 0.3, size=(640, nf)))
    return model.state_dict()


def _install(path, name, cfg, state=None):
    """``<path>/<name>.yaml`` (+ the checkpoint ``<path>/<name>``)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
    if state is not None:
        save_checkpoint(path, name, state, cfg["net"])


def _cfg(nf, sampling_t, **dataset):
    return {"dataset": dict(windows=W, pred_len=P_LEN, sampling_t=sampling_t, **dataset),
            "net": _net(nf), "train": {"train_model_select": "NsDiff_model"}}


def _network_record(rng, dyn, interval, step):
    """[T, Node] with a jump two thirds in, long enough for 12 windows at
    the facade's step after decimation."""
    n = (W + 11 * step) * interval
    ys = (rng.normal(size=(n, 6)) * 0.02).astype(np.float32).cumsum(axis=0) + 0.5
    ys[2 * n // 3:] += 1.0
    if dyn == "SIS":
        ys = np.abs(ys) * 1e-3
        ys[2 * n // 3:] += 0.5
    return {"ys_dynamic": ys, "ts_dynamic": (np.arange(n) * 0.1).astype(np.float32),
            "tp_values": np.linspace(0, 1, n).astype(np.float32)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from upgdm_tpu_torch.figures.common import (
        DATASETS, dynamics_filename, graph_name, parameters, slbp_source_path,
    )
    from upgdm_tpu_torch.eval.uncertainty import DEFAULT_SAMPLE_WINDOW_STEP

    root = tmp_path_factory.mktemp("figtree")
    ds, ews = root / "dataset", root / "ews_results"
    rng = np.random.default_rng(0)
    slbp_state, net_state = _checkpoint(2, 1), _checkpoint(1, 2)

    # SLBP records: 210,000 points (210 after the decimation by 1,000 of
    # sampling_t 100), a ramp in the last quarter
    n = 210_000
    for i, trend in enumerate(TRENDS):
        for j, d in enumerate(DV):
            r = np.random.default_rng(10 * i + j)
            ys = (r.normal(size=(n, 2)) * 1e-3).astype(np.float32).cumsum(axis=0) + 1.0
            ys[3 * n // 4:] += np.linspace(0, 3, n - 3 * n // 4, dtype=np.float32)[:, None]
            save_pt({"ys_dynamic": ys, "ts_dynamic": (np.arange(n) * 0.1).astype(np.float32),
                     "N_values": np.linspace(0, 3.5, n).astype(np.float32)},
                    slbp_source_path(ds, TT, trend, d))
    n_slbp = sliding_window_count(n // 1000, W, 10)  # 20 windows at step 10

    def samp(k, shape=(P_LEN, 2)):
        return [(rng.random(shape + (S,)) * (1.0 + 0.1 * i)).astype(np.float32)
                for i in range(k)]

    def gx(k, shape=(P_LEN, 2)):
        return [(rng.random(shape) + 0.5).astype(np.float32) for _ in range(k)]

    slbp_cfg = _cfg(2, 100)
    # fig4: sensitivity banks, each model with its cache
    for bank, name in (("NsDiff_pred", "dataset__w200p200st100"),
                       ("NsDiff_windows", "dataset__w200p200st100")):
        _install(ews / bank / "models", name, slbp_cfg, slbp_state)
        for trend in TRENDS:
            save_tensor_list(samp(n_slbp), ews / bank / "datas"
                             / f"{name}_pred_future_{trend}_10.pt")
    # fig5: the trends bank, caches only (96-window cache: the step is inferred)
    _install(ews / "NsDiff_trends/models", "dataset__w200p200st100", slbp_cfg)
    for d in DV:
        for trend in TRENDS:
            data = samp(n_slbp) if trend == "increase" else gx(n_slbp)
            save_tensor_list(data, ews / f"NsDiff_trends/datas/t21e3/D_{d}_{trend}.pt")
    # fig6 (and fig9's model): the machine's diffusion model and pretrain-g
    _install(ews / "NsDiff_machine/NsDiff/models", "dataset_w200p200st100", slbp_cfg, slbp_state)
    _install(ews / "NsDiff_machine/preg/models", "dataset_w200p200st100", slbp_cfg)
    for trend in TRENDS:
        save_tensor_list(samp(n_slbp), ews / "NsDiff_machine/NsDiff/datas"
                         / f"dataset_w200p200st100_pred_future_{trend}_10.pt")
        save_tensor_list(gx(n_slbp), ews / "NsDiff_machine/NsDiff/datas"
                         / f"dataset_w200p200st100_pred_future_{trend}_10_gx.pt")
        # the pretrain-g model's gx under the legacy name
        save_tensor_list(gx(n_slbp), ews / "NsDiff_machine/preg/datas"
                         / f"dataset_w200p200st100_pred_future_{trend}_10.pt")
        for d in DV:  # fig9: raw and smoothed
            for sub in (f"SLPB_{TT}", f"smooth_SLPB_T_{TT}"):
                save_tensor_list(gx(n_slbp), ews / "NsDiff_machine/NsDiff/datas" / sub
                                 / f"gx_D_{d}_{trend}.pt")
    # fig7: gx panels (yaml only) and ablations (checkpoint: prediction error)
    f7 = jmod("fig7_train_analysis")
    for folder, _t in f7.TRAIN_D_PANELS + f7.TRAIN_N_PANELS:
        _install(ews / "NsDiff_dataset_contant" / folder, "model_trained", slbp_cfg)
        for trend in TRENDS:
            save_tensor_list(gx(n_slbp), ews / "NsDiff_dataset_contant" / folder
                             / f"SLPB_{TT}" / f"gx_D_{DV[0]}_{trend}.pt")
    for folder, _t in f7.ABLATION_PANELS:
        _install(ews / "NsDiff_machine" / folder, "model_trained", slbp_cfg, slbp_state)
        for trend in TRENDS:
            save_tensor_list(samp(n_slbp), ews / "NsDiff_machine" / folder
                             / f"SLPB_{TT}" / f"D_{DV[0]}_{trend}.pt")
    # fig8
    for folder, _l, _s in jmod("fig8_train_source").MODEL_PANELS:
        _install(ews / "NsDiff_dataset" / folder, "model_trained", slbp_cfg)
        for trend in TRENDS:
            save_tensor_list(gx(n_slbp), ews / "NsDiff_dataset" / folder / f"SLPB_{TT}"
                             / f"gx_D_{DV[0]}_{trend}.pt")

    # network dynamics: records on the three test graphs, the model_compare
    # models (fig1, mpv_collapse) with their sampling and gx caches, and the
    # generalization banks (fig2, fig3: caches only)
    for dyn in DATASETS:
        step_fig, sampling_t = parameters(dyn)
        interval = sampling_interval_from_t(sampling_t)
        step = DEFAULT_SAMPLE_WINDOW_STEP[dyn]
        name = dynamics_filename(dyn, "increase")
        for gt in ("BA", "ER", "WS"):
            rec = _network_record(rng, dyn, interval, max(step, step_fig))
            save_pt(rec, ds / f"spdata_sde_{dyn}" / graph_name(gt) / name)
        T = len(rec["ts_dynamic"]) // interval
        k = sliding_window_count(T, W, step)
        mc = ews / "model_compare/NsDiff" / dyn
        _install(mc, "model_trained", _cfg(1, sampling_t), net_state)
        save_tensor_list(samp(k, (6, P_LEN, 1)), mc / name)
        save_tensor_list(gx(k, (6, P_LEN, 1)), mc / name.replace(".pt", "_gx.pt"))
        save_tensor_list(gx(k, (6, P_LEN, 1)), ews / "statistics_dataset" / dyn / GRAPH
                         / name.replace(".pt", "_gx.pt"))
        kf = sliding_window_count(T, W, step_fig)
        gen = ews / "ews_generalization"
        _install(gen / "graph" / dyn, "model_trained", _cfg(1, sampling_t))
        for gt in ("BA", "ER", "WS"):
            save_tensor_list(samp(kf, (6, P_LEN, 1)), gen / "graph" / dyn / f"{gt}_increase.pt")
        _install(gen / "dynamic" / dyn, "model_trained", _cfg(1, sampling_t))
    for trained_on in DATASETS:
        for dyn in DATASETS:
            step_fig, sampling_t = parameters(dyn)
            T = len(load_pt(ds / f"spdata_sde_{dyn}" / GRAPH
                            / dynamics_filename(dyn, "increase"))["ts_dynamic"])
            kf = sliding_window_count(T // sampling_interval_from_t(sampling_t), W, step_fig)
            save_tensor_list(samp(kf, (6, P_LEN, 1)), ews / "ews_generalization/dynamic"
                             / trained_on / dynamics_filename(dyn, "increase"))
    # an empirical record for the Bury plot
    save_pt({"ys_dynamic": rng.normal(size=(300, 2)).astype(np.float32),
             "ts_dynamic": np.arange(300, dtype=np.float32), "transition_index": 200,
             "data_type": "anoxia"}, ds / "real_data/anoxia.pt")
    return root


def _copy(tree, dst):
    shutil.copytree(tree, dst)
    return dst / "ews_results", dst / "dataset"


def _same(a, b, where="", roots=("", ""), atol=None):
    """Equal data, arrays within RTOL (or, where ``atol`` maps the end of
    the path to a tolerance, within that); paths compared below their tree."""
    atol = atol or {}
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}", roots, atol)
    elif isinstance(a, (list, tuple)) and not (a and np.isscalar(a[0]) and not isinstance(a[0], str)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]", roots, atol)
    elif isinstance(a, (str, Path)):
        assert str(a).replace(str(roots[0]), "<root>") == str(b).replace(str(roots[1]), "<root>"), where
    elif a is None or isinstance(a, bool):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        tol = next((v for k, v in atol.items() if where.endswith(k)), None)
        if tol is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=where)
        elif a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=where, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)


def _both(tree, tmp_path, fn, atol=None):
    """fn(module getter, ews_root, source_root, extra kwargs) in both packages,
    each on a copy of the tree; the two results compared."""
    out, roots = [], []
    for get, extra in ((jmod, {}), (pmod, {"device": "cpu"})):
        dst = tmp_path / ("j" if get is jmod else "p")
        ews, src = _copy(tree, dst)
        out.append(fn(get, ews, src, extra))
        roots.append(dst)
    _same(out[0], out[1], roots=tuple(roots), atol=atol)
    return out[1]


# -- imports ------------------------------------------------------------------

def test_port_modules_import_without_jax():
    mods = PORT_MODULES + ["upgdm_tpu_torch.eval.uncertainty",
                           "upgdm_tpu_torch.eval.diffusion_model_uncertainy",
                           "upgdm_tpu_torch.ops.rolling", "upgdm_tpu_torch.ops.windows"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'optax', 'upgdm_tpu', 'matplotlib'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- MPV-collapse statistics ----------------------------------------------------

def _rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for dyn in ("SIS", "biomass", "neuronal"):
        for topo in ("BA", "ER", "SW"):
            for trend in TRENDS:
                for k in range(3):
                    row = {"dynamic_type": dyn, "topology_type": topo, "trend": trend,
                           "skip_reason": "" if (k or topo != "SW") else "too_short"}
                    for m in JM.METRICS:
                        row[m] = float(rng.normal(50, 20)) if rng.random() > 0.1 else "nan"
                    t = np.arange(30, dtype=float) * 10
                    row.update(mpv_time=t, mpv_values=np.abs(rng.normal(1, 0.3, 30)),
                               baseline_mpv=1.0 + rng.random(), transition_time=200.0)
                    rows.append(row)
    return rows


def _csv(M, tmp, name, rows, fields):
    M.write_csv(tmp / name, rows, fields)
    return (tmp / name).read_bytes()


def _case_locate(M, tmp):
    rng = np.random.default_rng(1)
    t = np.arange(400, dtype=float)
    outs = []
    for dyn in ("SIS", "biomass", "SLBP"):
        for trend in TRENDS:
            s = np.abs(rng.normal(0, 1e-3, 400)).cumsum()
            s[250:] += 0.5
            outs.append(M.locate_transition(t, s, dyn, trend))
    outs.append(M.locate_transition(t[:5], np.ones(5), "biomass", "increase"))
    outs.append(M.locate_transition(t[:30], np.zeros(30), "SIS", "increase"))
    return outs


def _case_slopes(M, tmp):
    rng = np.random.default_rng(2)
    t = np.arange(80, dtype=float) * 3
    y = rng.normal(size=80).cumsum()
    y[[5, 40]] = np.nan
    return [M.compute_local_slopes(t, y, w) for w in (1, 3, 10, 200)]


def _case_metric_row(M, tmp):
    rng = np.random.default_rng(3)
    t = np.arange(120, dtype=float) * 5
    mpv = np.abs(rng.normal(1, 0.2, 120)) * np.linspace(1, 0.1, 120)
    return [M.metric_row_from_mpv(t, mpv, tt, swp)
            for tt in (400.0, 10.0, 900.0) for swp in (None, 7)]


def _case_slope_metrics(M, tmp):
    rng = np.random.default_rng(4)
    st = np.arange(50, dtype=float)
    return [M.slope_metrics_from_mpv(st, rng.normal(size=50), tt) for tt in (25.0, -1.0)] + [
        M.slope_metrics_from_mpv([], [], 3.0)]


def _case_summary(M, tmp):
    return M.build_summary_rows(_rows(5))


def _case_metric_matrix(M, tmp):
    s = M.build_summary_rows(_rows(6))
    return [M.build_metric_matrix(s, m) for m in M.METRICS]


def _case_count_matrix(M, tmp):
    return M.build_count_matrix(M.build_summary_rows(_rows(7)))


def _case_markdown(M, tmp):
    rows = _rows(8)
    M.write_markdown_summary(tmp / "s.md", M.build_summary_rows(rows), rows)
    return (tmp / "s.md").read_bytes()


def _case_csvs(M, tmp):
    rows = _rows(9)
    summary = M.build_summary_rows(rows)
    out = [_csv(M, tmp, "samples.csv", rows, M.SAMPLE_FIELDS),
           _csv(M, tmp, "summary.csv", summary, M.summary_fields())]
    for m in M.METRICS:
        out.append(_csv(M, tmp, f"{m}.csv", *reversed(M.build_metric_matrix(summary, m))))
    out.append(_csv(M, tmp, "n.csv", *reversed(M.build_count_matrix(summary))))
    recs = M.threshold_records_from_runtime(rows)
    M.write_relation_csv(tmp / "rel.csv", recs, "threshold")
    out.append((tmp / "rel.csv").read_bytes())
    return out


def _case_threshold_records(M, tmp):
    return M.threshold_records_from_runtime(_rows(10))


def _case_slope_relation(M, tmp):
    return M.slope_relation_records(_rows(11))


def _case_iter_files(M, tmp):
    names = ("SIS_dynamic_eta0.01d0.5_increase.pt", "SIS_dynamic_eta0.5d0.5_decrease.pt",
             "SIS_dynamic_eta0.02d0.5_decrease.pt", "x.pt")
    for topo in ("barabasi_albert_30_0", "erdos_renyi_50_0", "small-world_70_0", "grid_4"):
        d = tmp / "spdata_sde_SIS" / topo
        d.mkdir(parents=True, exist_ok=True)
        for n in names:
            (d / n).write_bytes(b"x")
    out = []
    for kw in ({}, {"exclude_eta": ["0.5"]}, {"include_eta": ["0.02"]},
               {"topology_types": ["ER"]}, {"topologies": ["small-world_70_0"]}):
        out.append([(a, b, c, d, e, f.name) for a, b, c, d, e, f in M.iter_data_files(
            tmp, ["SIS", "biomass"], list(TRENDS), **kw)])
    return out


MPV_CASES = {
    "locate_transition": _case_locate, "compute_local_slopes": _case_slopes,
    "metric_row_from_mpv": _case_metric_row, "slope_metrics_from_mpv": _case_slope_metrics,
    "build_summary_rows": _case_summary, "build_metric_matrix": _case_metric_matrix,
    "build_count_matrix": _case_count_matrix, "markdown": _case_markdown, "csvs": _case_csvs,
    "threshold_records_from_runtime": _case_threshold_records,
    "slope_relation_records": _case_slope_relation, "iter_data_files": _case_iter_files,
}


@pytest.mark.parametrize("case", sorted(MPV_CASES))
def test_mpv_collapse_helpers_match_jax(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = MPV_CASES[case](JM, tmp_path / "j")
    got = MPV_CASES[case](PM, tmp_path / "p")
    _same(want, got, case, roots=(tmp_path / "j", tmp_path / "p"))


def test_mpv_collapse_on_demo_fig1_matches_jax(tmp_path):
    """The statistics CLI over a copy of the tracked ``demo_fig1`` tree (the
    trained NsDiff arms, gx only): the port on the CPU writes the JAX
    package's rows. Every field is equal but those computed from gx: its MPV
    values within the gx bar of 1e-5 (``test_torch_port_facade.py``), the
    drops, 100 (baseline - min) / baseline, within 100 x 2e-5 percentage
    points of it, the OLS slopes of the MPV within 1e-4 (measured 8.4e-6).
    The neuronal record's transition (t = 5.01) leaves too few MPV points
    before it, in both packages."""
    rows = {}
    for M, extra in ((JM, []), (PM, ["--device", "cpu"])):
        src = tmp_path / M.__name__.split(".")[0]
        shutil.copytree(REPO / "demo_fig1", src, ignore=shutil.ignore_patterns("figures"))
        M.main(["--ews-root", str(src / "ews_results"), "--source-root", str(src),
                "--output-dir", str(src / "out"), "--model-name", "NsDiff", *extra])
        with open(src / "out/mpv_collapse_samples.csv", newline="") as f:
            rows[M] = [{k: v.replace(str(src), "<root>") for k, v in r.items()}
                       for r in csv.DictReader(f)]
    assert [r["skip_reason"] for r in rows[PM]] == ["", "too_few_pre_transition_mpv_points", ""]
    bars = {"baseline_mpv": (1e-5, 0), "min_mpv_before_transition": (1e-5, 0),
            "min_mpv_global": (1e-5, 0), "pre_transition_drop_percent": (0, 2e-3),
            "global_drop_percent": (0, 2e-3), "min_slope_before_transition": (1e-4, 0),
            "min_slope_global": (1e-4, 0)}
    for a, b in zip(rows[JM], rows[PM]):
        assert {k: v for k, v in a.items() if k not in bars} == {
            k: v for k, v in b.items() if k not in bars}
        for k, (rtol, atol) in bars.items():
            assert bool(a[k]) == bool(b[k]), k
            if a[k]:
                np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=rtol, atol=atol,
                                           err_msg=k, equal_nan=True)


def test_locate_transition_on_the_tracked_trajectory():
    """The demo's own call: every 1,000th point of the bream state."""
    rec = load_pt(next((REPO / "demo_artifacts/slbp_data").rglob("*.pt")))
    ts = np.asarray(rec["ts_dynamic"], float)[::1000]
    xs = np.asarray(rec["ys_dynamic"], float)[::1000, 0]
    want = json.loads((REPO / "demo_artifacts/summary.json").read_text())
    got = PM.locate_transition(ts, xs, "SLBP", "increase")
    assert got["transition_time"] == want["transition_time_state"] == 168300.078125
    _same(JM.locate_transition(ts, xs, "SLBP", "increase"), got)


def test_common_and_composer_helpers_match_jax():
    jc, pc = jmod("common"), pmod("common")
    for dyn in ("biomass", "neuronal", "SIS"):
        for trend in TRENDS:
            assert pc.dynamics_filename(dyn, trend) == jc.dynamics_filename(dyn, trend)
        assert pc.dynamics_title(dyn) == jc.dynamics_title(dyn)
        assert pc.parameters(dyn) == jc.parameters(dyn)
    for g in ("BA", "ER", "WS"):
        assert pc.graph_name(g) == jc.graph_name(g)
    for fn in ("dynamics_filename", "graph_name", "dynamics_title", "parameters"):
        args = ("x", "increase") if fn == "dynamics_filename" else ("x",)
        with pytest.raises(ValueError):
            getattr(jc, fn)(*args)
        with pytest.raises(ValueError):
            getattr(pc, fn)(*args)
    assert (pc.slbp_source_path("r", TT, "increase", "1e-05", True)
            == jc.slbp_source_path("r", TT, "increase", "1e-05", True))
    assert pc.spdata_source_path("r", "SIS", GRAPH, "a.pt") == jc.spdata_source_path(
        "r", "SIS", GRAPH, "a.pt")
    assert pc.graph_file("r", GRAPH) == jc.graph_file("r", GRAPH)
    assert (pc.PROJECT_ROOT, pc.EWS_ROOT, pc.OUTPUT_ROOT) == (jc.PROJECT_ROOT, jc.EWS_ROOT,
                                                              jc.OUTPUT_ROOT)
    rng = np.random.default_rng(12)
    t = np.arange(300, dtype=float)
    for dyn in ("biomass", "SIS"):
        for trend in TRENDS:
            s = np.abs(rng.normal(0, 1e-3, 300)).cumsum()
            s[200:] += 0.4 if trend == "increase" else -0.4
            assert pc.transition_time(t, s, dyn, trend) == jc.transition_time(t, s, dyn, trend)
        assert pc.transition_time(t[:5], s[:5], dyn, "increase") == jc.transition_time(
            t[:5], s[:5], dyn, "increase")
    for ews in (rng.random(40), np.zeros(12), np.array([]), np.r_[np.nan, rng.random(9)]):
        _same(jc.relative_uncertainty(ews), pc.relative_uncertainty(ews))
    x, y = np.arange(5000.0), rng.random(5000)
    _same(jc.thin_for_plot(x, y, max_points=700), pc.thin_for_plot(x, y, max_points=700))
    _same(jc.thin_for_plot(x[:9], y[:9]), pc.thin_for_plot(x[:9], y[:9]))
    # fig9's causal moving average and the composer's crop
    series = rng.normal(size=(500, 2)).astype(np.float32)
    for window, axis in ((21, 0), (3, 0), (1, 0), (7, 1)):
        s = series if axis == 0 else series.T
        got = pmod("fig9_smoothing").causal_moving_average(s, window, axis)
        want = jmod("fig9_smoothing").causal_moving_average(s, window, axis)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    img = np.full((120, 90, 4), 255, np.uint8)
    img[40:60, 30:70, :3] = 10
    for kw in ({}, {"pad": 2}, {"threshold": 5}):
        np.testing.assert_array_equal(pmod("figure_composer").crop_white_margin(img, **kw),
                                      jmod("figure_composer").crop_white_margin(img, **kw))
    blank = np.full((10, 10, 4), 255, np.uint8)
    assert pmod("figure_composer").crop_white_margin(blank) is blank
    rec = {"ts_dynamic": np.arange(10.0), "ys_dynamic": np.zeros((10, 3))}
    for extra in ({"transition_index": 40}, {"transition_time": 3.5}, {"transition_age": 6.2},
                  {"data_type": "anoxia"}, {"data_type": "thermoacoustic"}, {}):
        r = dict(rec, **extra)
        assert (pmod("plot_bury_transitions").transition_x(r)
                == jmod("plot_bury_transitions").transition_x(r))
        assert (pmod("plot_bury_transitions").channel_labels(r)
                == jmod("plot_bury_transitions").channel_labels(r))


# -- the figures' loaders on the micro tree ---------------------------------------

def _fig1(get, ews, src, extra):
    return get("fig1_model_compare").collect_fig1_data(ews, src, "increase", GRAPH,
                                                       ("NsDiff",), **extra)


def _fig2(get, ews, src, extra):
    return [get("fig2_graph_generalization").load_panel_data(ews, src, dyn, "increase", gt,
                                                             **extra)
            for dyn in ("biomass", "SIS") for gt in ("BA", "WS")]


def _fig3(get, ews, src, extra):
    return [get("fig3_dynamics_transfer").load_panel_data(ews, src, dyn, "increase", **extra)
            for dyn in ("neuronal", "SIS")]


def _fig4(get, ews, src, extra):
    return [get("fig4_model_sensitivity").load_sensitivity_data(
        ews, src, trend, metric, total_time=TT, d_value=DV[0], pred_lens=(200,),
        window_lens=(200,), **extra) for trend, metric in (("increase", "mpv"),
                                                           ("decrease", "prediction_error"))]


def _fig5(get, ews, src, extra):
    return [get("fig5_tipping_types").load_panel_data(ews, src, trend, TT, "t21e3", d, 10,
                                                      **extra)
            for d in DV for trend in TRENDS]


def _fig6(get, ews, src, extra):
    return [get("fig6_slbp_model_analysis").load_panel_data(ews, src, trend, total_time=TT,
                                                            d_value=DV[1], **extra)
            for trend in TRENDS]


def _fig7(get, ews, src, extra):
    m = get("fig7_train_analysis")
    time_data, series = m.load_dynamic_record(m.slbp_source_path(src, TT, "increase", DV[0]))
    return ([m.load_gx_panel(ews, series, time_data, "increase", f, t, TT, DV[0], **extra)
             for f, t in m.TRAIN_D_PANELS[:2]]
            + [m.load_ablation_panel(ews, series, time_data, "increase", f, t, TT, DV[0],
                                     **extra) for f, t in m.ABLATION_PANELS[:2]])


def _fig8(get, ews, src, extra):
    m = get("fig8_train_source")
    rec = m.load_slbp_record(src, "decrease", TT, DV[0])
    return [rec] + [m.load_mpv(ews / "NsDiff_dataset" / f, rec, "decrease", TT, DV[0], **extra)
                    for f, _l, _s in m.MODEL_PANELS]


def _fig9(get, ews, src, extra):
    return [get("fig9_smoothing").load_signal(ews, src, DV[1], "increase", smooth, TT, **extra)
            for smooth in (False, True)]


def _mpv_collapse(get, ews, src, extra):
    m = get("mpv_collapse")
    from argparse import Namespace

    args = Namespace(ews_root=ews, output_dir=ews.parent / "out", model_name="NsDiff",
                     dry_run=False, pred_dim=0, force_recompute=False, slope_window_ratio=0.25,
                     plot_checks=False, **extra)
    files = list(m.iter_data_files(src, ["SIS", "neuronal", "biomass"], ["increase"],
                                   topologies=[GRAPH]))
    assert len(files) == 3
    return [m.analyze_file(args, *info) for info in files]


LOADERS = {"fig1": _fig1, "fig2": _fig2, "fig3": _fig3, "fig4": _fig4, "fig5": _fig5,
           "fig6": _fig6, "fig7": _fig7, "fig8": _fig8, "fig9": _fig9,
           "mpv_collapse": _mpv_collapse}


@pytest.mark.parametrize("fig", sorted(LOADERS))
def test_figure_loaders_match_jax(fig, tree, tmp_path):
    # fig6's raw-window-variance control is float32 arithmetic summed in
    # another order than XLA's: held to its bound (test_torch_port_slbp.py)
    # over 200-point windows of the micro records, which stay below 4.5
    atol = {"raw_variance.variance": var_tol(200, 4.5)} if fig == "fig6" else None
    got = _both(tree, tmp_path, LOADERS[fig], atol)
    if fig == "mpv_collapse":  # every trajectory made it into the statistics
        assert [r["skip_reason"] for r in got] == ["", "", ""], got
    if fig == "fig6":
        assert all(p["sampling"]["available"] for p in got)
        assert len(got[0]["raw_variance"]["variance"]) == 2  # W 200, step 10 in 210 points


# -- the CLIs, rendered on the CPU --------------------------------------------------

CLIS = {
    "fig1_model_compare": ["--graph", GRAPH, "--models", "NsDiff"],
    "fig2_graph_generalization": ["--graph-types", "BA", "ER"],
    "fig3_dynamics_transfer": [],
    "fig4_model_sensitivity": ["--total-time", TT, "--d-value", DV[0], "--pred-lens", "200",
                               "--window-lens", "200"],
    "fig5_tipping_types": ["--d-values", *DV, "--time-rows", f"{TT}:t21e3:10"],
    "fig6_slbp_model_analysis": ["--total-time", TT, "--d-value", DV[0]],
    "fig7_train_analysis": ["--total-time", TT, "--d-value", DV[0]],
    "fig8_train_source": ["--total-time", TT, "--d-value", DV[0], "--train-end", "10000"],
    # one column per noise: a single noise leaves np.atleast_2d a row of
    # three axes, in both packages
    "fig9_smoothing": ["--total-time", TT, "--noises", *DV],
}
PNGS = {"fig1_model_compare": "fig1_model_compare_increase.png",
        "fig2_graph_generalization": "fig2_graph_generalization_increase.png",
        "fig3_dynamics_transfer": "fig3_dynamics_transfer_increase.png",
        "fig4_model_sensitivity": "fig4_model_sensitivity_mpv_increase.png",
        "fig5_tipping_types": "fig5_tipping_types.png",
        "fig6_slbp_model_analysis": "fig6_slbp_model_analysis.png",
        "fig7_train_analysis": "fig7_train_analysis_increase.png",
        "fig8_train_source": "fig8_train_source_comparison.png",
        "fig9_smoothing": "fig9_smoothing_increase.png"}


def test_port_clis_render_on_the_cpu(tree, tmp_path):
    ews, src = _copy(tree, tmp_path / "tree")
    for fig, argv in CLIS.items():
        out = tmp_path / "out" / fig
        pmod(fig).main(["--ews-root", str(ews), "--source-root", str(src),
                        "--output-dir", str(out), "--device", "cpu", *argv])
        png = out / PNGS[fig]
        assert png.exists() and png.stat().st_size > 10_000, fig
    out = tmp_path / "out" / "mpv_collapse"
    PM.main(["--ews-root", str(ews), "--source-root", str(src), "--output-dir", str(out),
             "--topology", GRAPH, "--trends", "increase", "--device", "cpu", "--plot-checks",
             "--plot-summary-relations"])
    with open(out / "mpv_collapse_samples.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and all(r["skip_reason"] == "" for r in rows)
    assert all(Path(r["check_plot_path"]).exists() for r in rows)
    assert (out / "mpv_slope_lead_time.png").exists()
    pmod("plot_bury_transitions").main(["--files", str(src / "real_data/anoxia.pt"),
                                        "--output-dir", str(tmp_path / "out/bury")])
    assert (tmp_path / "out/bury/bury_real_transition_points.png").exists()
    # the figure CLIs ask for the card by default, and raise without one
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmod("fig9_smoothing").main(["--ews-root", str(ews), "--source-root", str(src),
                                         "--output-dir", str(tmp_path / "x"),
                                         "--total-time", TT, "--noises", DV[0]])



@pytest.mark.parametrize("fig", sorted(CLIS))
def test_port_clis_without_matplotlib_run_the_same_loaders(fig, tree, tmp_path, monkeypatch):
    """Without matplotlib (the card's machine) a figure CLI calls the same
    loaders with the same arguments as with it, and writes no image."""
    from upgdm_tpu_torch.figures import common

    ews, src = _copy(tree, tmp_path / "tree")
    argv = ["--ews-root", str(ews), "--source-root", str(src), "--device", "cpu", *CLIS[fig]]
    mod, calls = pmod(fig), []

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append((name, repr(args), repr(sorted(kwargs.items()))))
            return fn(*args, **kwargs)
        return call

    for name in [n for n in vars(mod) if n.startswith("load_") and callable(getattr(mod, n))]:
        monkeypatch.setattr(mod, name, recorded(name, getattr(mod, name)))
    with monkeypatch.context() as m:
        m.setattr(common, "can_render", lambda: False)
        mod.main(argv + ["--output-dir", str(tmp_path / "out")])
    bare, calls[:] = list(calls), []
    assert not list((tmp_path / "out").glob("**/*.*"))
    mod.main(argv + ["--output-dir", str(tmp_path / "out")])
    assert bare and bare == calls
    assert (tmp_path / "out" / PNGS[fig]).exists()

def test_plot_single_model_check_renders(tmp_path):
    from upgdm_tpu_torch.eval.uncertainty import plot_single_model_check

    rng = np.random.default_rng(13)
    result = {"dynamic_type": "SLBP", "torch_time_series": rng.normal(size=(1, 300, 2)),
              "time_data": np.arange(300.0), "time_points": np.arange(99.0, 300.0, 10.0),
              "ews": rng.random(21)}
    fig = plot_single_model_check(result, pred_dim=1, title="t", save_path=tmp_path / "a.png")
    assert (tmp_path / "a.png").stat().st_size > 10_000
    net = dict(result, dynamic_type="SIS", torch_time_series=rng.normal(size=(6, 300, 1)))
    import matplotlib.pyplot as plt

    _, axs = plt.subplots(2, 1)
    assert plot_single_model_check(net, axs=axs) is axs[0].figure
    with pytest.raises(ValueError):
        plot_single_model_check(net, axs=[axs[0]])
    plt.close("all")
    del fig
