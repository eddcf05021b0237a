"""The port's pipelines on the card, each against the tracked records.

``slbp``: the six SLBP analyses at the trained demo model's full width
(``demo_artifacts/model`` over the tracked trajectory, 191 windows, K1 at
160,000 rows and F 2) with their K1 launches, gx and the float32 ensemble
against the CPU, K1 at that shape against its twin, and the demo's scan
through the facade held to ``demo_artifacts/summary.json`` over two seeds.
``figures``: the figure layer's loaders (fig1 and ``mpv_collapse`` over
``demo_fig1``, fig4-fig9 over the tracked SLBP model and trajectory under
every name they read), rendered when matplotlib is installed. ``datagen``:
K4 against its twin, the simulators against the CPU, the JAX package's
default SLBP corpus, the demo corpus over eight seeds, generated records
through the facade, the network CLI, the graph library and the Bury corpus.
``real_data``: the Bury classifiers and the signal stage against the CPU, a
reference-format checkpoint. ``multi_gpu``: the ``torch.distributed`` layer on
the one card. ``examples``: the experiment drivers of ``examples/`` at their
defaults or at cut depth. Every case skips without a CUDA device; on the
card (see ``card_checks.py``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_pipelines.py -m card
"""
import contextlib
import csv
import importlib.util
import io
import json
import random
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from card_checks import (
    CHUNK, DEMO, MG_CHUNK_2, MG_SEED, MG_TRAIN_B, N_WINDOWS, N_Z, NET_PARAM, NODE, PRED_LEN,
    REPO, SIS_MODEL, STEPS, STG_ATOL, STG_RTOL, T_CHUNK, T_STEPS, T_WINDOWS, TMDM_PARAM,
    TRAIN_GRAD_REL, TRAIN_GRAD_ZERO, TRAIN_LOSS_RTOL, WINDOWS, Forwards, assert_updates,
    TOL, card, counts, demo_split, dp_train_steps, grid_dataset, kernel_counts,  # noqa: F401
    make_windows, two_rank_check, zero_counts,
)
from test_torch_port_examples import artifact_names

HAVE_MPL = importlib.util.find_spec("matplotlib") is not None

# The SLBP analyses at the trained demo model's full width: demo_artifacts/model
# (NsDiff, d_model 64 e2/d1, d_ff 128, F 2, W/P 100/100, 20 steps, n_z 100) over the
# tracked trajectory (2,000,000 x 2, sampling_t 100 -> 2,000 points: 191 windows at
# the step 10, 181 targets), in chunks of 16 windows: 12 chunks of 20 K1 launches
# at 16 x 100 x 100 = 160,000 rows (examples/slbp_demo.py:146-156)
SLBP_MODEL = DEMO / "model"
SLBP_NAME = "dataset__w100p100st100"
SLBP_WINDOWS, SLBP_TARGETS, SLBP_CHUNK, SLBP_ROWS = 191, 181, 16, 16 * 100 * 100
SLBP_K1 = STEPS * -(-SLBP_WINDOWS // SLBP_CHUNK)  # 240 launches a sweep
SLBP_GX_WINDOWS, SLBP_SAMPLE_WINDOWS = 8, 2
# g(x) on the card against the CPU (tests/test_torch_parity.py); the demo
# scan's gx metrics against demo_artifacts/summary.json (both packages on
# the CPU reproduce them within 0.1%: tests/test_torch_port_slbp.py::
# test_gx_metrics_reproduce_the_demo_record); its sampling metrics (statistics of
# 100 draws a window, on another RNG stream than the record's) against the
# same record at 3%: two card seeds gave 0.64% and 1.06% at most, 0.8% apart
SLBP_GX_TOL, SLBP_GX_REL, SLBP_SAMPLING_REL = 1e-4, 0.01, 0.03
SLBP_METRICS = ("baseline_mpv", "pre_transition_drop_percent", "global_drop_percent")
# the figures' SLBP tree: the tracked model under every name fig4-fig9 read, the
# tracked trajectory under every record name (examples/paper_figures_demo.py's
# layout at the demo's total time)
FIG_TT, FIG_D, FIG_NOISES = "200000.0", "1e-05", ("1e-05", "5e-06")
# mpv_collapse over demo_fig1: each row's skip reason and gx baseline MPV as the
# JAX package gives them on the CPU (python -m upgdm_tpu.figures.mpv_collapse
# --ews-root demo_fig1/ews_results --source-root demo_fig1 --model-name NsDiff;
# tests/test_torch_port_figures.py::test_mpv_collapse_on_demo_fig1_matches_jax
# holds the port's CPU rows to JAX's); the neuronal record's transition
# (t = 5.01) leaves too few MPV points before it
MC_EXPECTED = {"biomass": ("", 0.04759270538176809),
               "neuronal": ("too_few_pre_transition_mpv_points", None),
               "SIS": ("", 0.7768259048461914)}


def finite(values, n=None, positive=True):
    v = np.asarray(values, float)
    return ((n is None or v.shape == (n,)) and v.size > 0 and np.isfinite(v).all()
            and (not positive or (v > 0).all()))


def install_slbp_model(models_dir, name):
    """The tracked SLBP model as ``models_dir/<name>`` + ``<name>.yaml``."""
    models_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(SLBP_MODEL / "model_trained", models_dir / name)
    shutil.copy(SLBP_MODEL / "model_trained.yaml", models_dir / f"{name}.yaml")


def slbp_record():
    from upgdm_tpu_torch.utils.io import load_pt

    data_file = next((DEMO / "slbp_data").rglob("*.pt"))
    rec = load_pt(data_file)
    return data_file, np.asarray(rec["ys_dynamic"]), np.asarray(rec["ts_dynamic"])


# -- slbp -----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slbp(card, tmp_path_factory):
    """The six SLBP analyses on the card over the 191 windows of the tracked
    model and trajectory, each with its launches of (K1, K2, K3) and its
    update launches held to one a K1 launch: the sensitivity sweep (a chunk
    into a cache of its own first); the sampling analysis served from its
    cache and the gx analysis (and gx on the CPU); the MPV analysis written
    then hit; the direct analysis on gx then on sampling; the raw window
    variance on the card and the CPU; the demo's scan through the facade
    under two seeds."""
    from unittest import mock

    from upgdm_tpu_torch.eval import uncertainty as U

    tmp = tmp_path_factory.mktemp("slbp")
    data_file, series, tdata = slbp_record()
    out = SimpleNamespace(launches={})

    def counted(name, fn):
        zero_counts()
        r = fn()
        out.launches[name] = kernel_counts()
        assert_updates(name, out.launches[name][0])
        return r

    # the model's yaml loads its pretrain stages from paths under the repo root
    with contextlib.chdir(REPO):
        root, cpu_root, model_dir = tmp / "card", tmp / "cpu", tmp / "model"
        for r in (root, cpu_root):
            install_slbp_model(r / "models", SLBP_NAME)
        shutil.copytree(SLBP_MODEL, model_dir)
        args = (SLBP_NAME, series, tdata)
        U.slbp_sensitivity_ews(root, *args, data_trend="warm", max_windows=SLBP_CHUNK,
                               device="cuda")
        out.sens = counted("sensitivity", lambda: U.slbp_sensitivity_ews(root, *args,
                                                                        device="cuda"))
        out.samp = counted("sampling", lambda: U.slbp_sampling_analysis(
            root, *args, device="cuda", allow_unavailable=False))
        out.gx = counted("gx", lambda: U.slbp_gx_analysis(root, *args, device="cuda"))
        out.gx_cpu = U.slbp_gx_analysis(cpu_root, *args, device="cpu",
                                        max_windows=SLBP_GX_WINDOWS)
        cache = tmp / "trends" / "D_1e-05_increase.pt"
        out.mpv_w = counted("mpv_write", lambda: U.slbp_mpv_analysis(root, *args, cache,
                                                                     device="cuda"))
        out.mpv_h = counted("mpv_hit", lambda: U.slbp_mpv_analysis(root, *args, cache,
                                                                   device="cuda"))
        out.d_gx = counted("direct_gx", lambda: U.slbp_direct_model_cache_analysis(
            model_dir, series, tdata, tmp / "direct/gx.pt", cache_kind="gx", device="cuda"))
        out.d_s = counted("direct_sampling", lambda: U.slbp_direct_model_cache_analysis(
            model_dir, series, tdata, tmp / "direct/samp.pt", cache_kind="sampling",
            compute_prediction_error=True, device="cuda"))
        out.raw = U.slbp_raw_window_variance(series, tdata, windows=100, sampling_t=100,
                                             device="cuda")
        out.raw_cpu = U.slbp_raw_window_variance(series, tdata, windows=100, sampling_t=100,
                                                 device="cpu")
        # the demo's scan through the facade (examples/slbp_demo.py:146-156), two seeds
        orig_load = U.load_model_from_dir
        out.scans = {}
        for seed in (0, 1):
            def seeded(*a, **k):
                m, p = orig_load(*a, **k)
                m.generator.manual_seed(seed)
                return m, p

            sub = tmp / f"scan{seed}"
            with mock.patch.object(U, "load_model_from_dir", seeded):
                out.scans[seed] = counted(f"scan{seed}", lambda: U.uncertainty_ews(
                    model_save_file=model_dir, data_file=data_file, dynamic_type="SLBP",
                    cache_path=sub / "mpv_cache.pt", nsdiff_g_path=sub / "mpv_cache_gx.pt",
                    sample_window_step=10, uncertainty_method="both", chunk_windows=16,
                    load_model_when_cached=True, device="cuda"))
    out.root, out.cpu_root, out.tmp = root, cpu_root, tmp
    return out


@pytest.mark.card
def test_slbp_sensitivity_sweep(slbp):
    sens, launches = slbp.sens, slbp.launches["sensitivity"]
    assert (len(sens["mpv"]) == SLBP_WINDOWS and finite(sens["mpv"], SLBP_WINDOWS)
            and finite(sens["prediction_error"], SLBP_TARGETS)
            and launches == (SLBP_K1, 0, 0)), (
        f"sensitivity: {len(sens['mpv'])} windows, K1/K2/K3 launches {launches}")


@pytest.mark.card
def test_slbp_sampling_from_the_sensitivity_cache(slbp):
    samp, sens, launches = slbp.samp, slbp.sens, slbp.launches["sampling"]
    assert (samp["available"] and samp["cache_path"] == sens["cache_path"]
            and samp["mpv"] == [float(v) for v in sens["mpv"]]
            and len(samp["intrinsic_dimension"]) == SLBP_WINDOWS
            and launches == (0, 0, 0)), f"sampling: {samp['reason']!r}, launches {launches}"


@pytest.mark.card
def test_slbp_gx_against_the_cpu(slbp):
    gx, launches = slbp.gx, slbp.launches["gx"]
    a, b = np.asarray(gx["gx_mpv"][:SLBP_GX_WINDOWS]), np.asarray(slbp.gx_cpu["gx_mpv"])
    gx_over = float(np.max(np.abs(a - b) - (SLBP_GX_TOL + SLBP_GX_TOL * np.abs(b))))
    assert finite(gx["gx_mpv"], SLBP_WINDOWS) and launches == (0, 0, 0) and gx_over <= 0, (
        f"gx: card off the CPU by {gx_over} over the bar, launches {launches}")


@pytest.mark.card
def test_slbp_mpv_analysis_written_then_hit(slbp):
    w, h, lw, lh = slbp.mpv_w, slbp.mpv_h, slbp.launches["mpv_write"], slbp.launches["mpv_hit"]
    assert (lw == (SLBP_K1, 0, 0) and lh == (0, 0, 0) and h["mpv"] == w["mpv"]
            and finite(w["mpv"], SLBP_WINDOWS) and h["sample_window_step"] == 10
            and h["uncertainty_source"] == "sampling"), f"mpv analysis: launches {lw} / {lh}"


@pytest.mark.card
def test_slbp_direct_analyses(slbp):
    d_gx, d_s = slbp.d_gx, slbp.d_s
    l_gx, l_s = slbp.launches["direct_gx"], slbp.launches["direct_sampling"]
    d_gx_rel = float(np.max(np.abs(np.asarray(d_gx["mpv"]) - slbp.gx["gx_mpv"])
                            / np.asarray(slbp.gx["gx_mpv"])))
    assert (d_gx["uncertainty_source"] == "gx" and d_gx_rel <= 1e-6 and l_gx == (0, 0, 0)
            and d_s["uncertainty_source"] == "sampling" and finite(d_s["mpv"], SLBP_WINDOWS)
            and finite(d_s["prediction_error"], SLBP_TARGETS)
            and l_s == (SLBP_K1, 0, 0)), (
        f"direct: gx {d_gx_rel} off the gx analysis, launches {l_gx} / {l_s}")


@pytest.mark.card
def test_slbp_raw_window_variance(slbp):
    raw_d = float(np.max(np.abs(slbp.raw["variance"] - slbp.raw_cpu["variance"])))
    assert finite(slbp.raw["variance"], SLBP_WINDOWS) and raw_d == 0.0, (
        f"raw window variance: card off the CPU by {raw_d}")


@pytest.mark.card
def test_slbp_float32_ensemble_against_the_cpu(slbp):
    """The card's float32 ensemble against the CPU's, per sample, shared noise."""
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.ops.windows import slbp_sensitivity_windows

    _, series, tdata = slbp_record()
    win = slbp_sensitivity_windows(series, tdata, 100, 100, 100, 10)[0]
    f32 = {"sampling_dtype": "float32"}
    with contextlib.chdir(REPO):
        mc, _, _ = U.load_sensitivity_model(slbp.root, SLBP_NAME, device="cuda",
                                            infer_params=f32)
        mh, _, _ = U.load_sensitivity_model(slbp.cpu_root, SLBP_NAME, device="cpu",
                                            infer_params=f32)
    x = np.asarray(mc.scaler_transform(win[:SLBP_SAMPLE_WINDOWS]), np.float32)
    rng = np.random.default_rng(9)
    noise = [rng.standard_normal((mc.n_z_samples,) + x.shape[:1] + (mc.pred_len, 2))
             .astype(np.float32) for _ in range(mc.diffusion_steps)]
    ens_c = mc.sample_chain(*mc.f_and_g(x), noise=noise).cpu()
    ens_h = mh.sample_chain(*mh.f_and_g(x), noise=noise)
    ens_over = ((ens_c - ens_h).abs() - (STG_ATOL + STG_RTOL * ens_h.abs())).max().item()
    assert torch.isfinite(ens_c).all().item() and ens_over <= 0, (
        f"float32 ensemble: card off the CPU by {ens_over} over rtol {STG_RTOL} atol {STG_ATOL}")


@pytest.mark.card
def test_slbp_k1_at_its_shape(slbp):
    """K1 at this path's shape (160,000 rows, F 2, bf16 matmuls) against its twin."""
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, fused_denoiser_rows_reference,
        step_weights,
    )

    with contextlib.chdir(REPO):
        model, _, _ = U.load_sensitivity_model(slbp.root, SLBP_NAME, device="cuda")
    with torch.no_grad():
        den = model.denoiser
        W = denoiser_weights(den)
        gen = torch.Generator(device="cuda").manual_seed(3)
        xk = torch.randn(SLBP_ROWS, 6, generator=gen, device="cuda")
        xk[:, 4:] = xk[:, 4:].abs() + 0.05  # gx > 0
        g7, kw16 = denoiser_gammas(den, 7), step_weights(W, torch.bfloat16)
        got = fused_denoiser_rows(xk, g7, kw16, matmul_dtype="bfloat16")
        want = fused_denoiser_rows_reference(xk, g7, W, matmul_dtype="bfloat16")
        k1_err = max((p - q).abs().max().item() for p, q in zip(got, want))
    assert k1_err <= TOL["bfloat16"], f"K1 at {SLBP_ROWS} rows, F 2: off its twin by {k1_err}"


@pytest.mark.card
@pytest.mark.parametrize("seed", (0, 1))
def test_slbp_demo_scan_against_the_record(slbp, seed):
    from upgdm_tpu_torch.figures.mpv_collapse import locate_transition, metric_row_from_mpv

    _, series, tdata = slbp_record()
    record = json.loads((DEMO / "summary.json").read_text())
    transition = locate_transition(np.asarray(tdata, float)[::1000],
                                   np.asarray(series, float)[::1000, 0], "SLBP",
                                   "increase")["transition_time"]
    assert transition == record["transition_time_state"], (
        f"transition {transition} vs the record's {record['transition_time_state']}")
    r, launches = slbp.scans[seed], slbp.launches[f"scan{seed}"]
    m_s = metric_row_from_mpv(r["time_points"], r["ews"], transition, slope_window_points=10)
    m_g = metric_row_from_mpv(r["nsdiff_g"]["time_points"], r["nsdiff_g"]["ews"], transition,
                              slope_window_points=10)
    assert (m_s.get("skip_reason") == "" and m_g.get("skip_reason") == ""
            and len(r["ews"]) == SLBP_WINDOWS and finite(r["ews"], SLBP_WINDOWS)
            and launches == (SLBP_K1, 0, 0)), (
        f"scan seed {seed}: {len(r['ews'])} windows, launches {launches}, skips "
        f"{m_s.get('skip_reason')!r} / {m_g.get('skip_reason')!r}")
    gx_rel = max(abs(m_g[k] / record["gx_mpv"][k] - 1) for k in SLBP_METRICS)
    s_rel = max(abs(m_s[k] / record["sampling_mpv"][k] - 1) for k in SLBP_METRICS)
    assert gx_rel <= SLBP_GX_REL and s_rel <= SLBP_SAMPLING_REL, (
        f"scan seed {seed} against demo_artifacts/summary.json: gx {gx_rel:.4%} "
        f"(bar {SLBP_GX_REL:.0%}), sampling {s_rel:.4%} (bar {SLBP_SAMPLING_REL:.0%})")
    if HAVE_MPL:
        from upgdm_tpu_torch.eval.uncertainty import plot_single_model_check

        png = slbp.tmp / f"slbp_mpv_collapse_{seed}.png"
        plot_single_model_check(r, title="SLBP NsDiff MPV", save_path=png)
        assert png.exists() and png.stat().st_size > 0, "plot_single_model_check wrote no PNG"


# -- figures --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def figures(card, tmp_path_factory):
    """The figure layer on the card over temporary copies of the tracked
    trees: fig1's data over ``demo_fig1`` (the NsDiff arm of each dynamics,
    swept through K1), ``mpv_collapse`` over the same tree, and fig4-fig9's
    loaders over a tree with the tracked SLBP model under every name they
    read and the tracked trajectory under every record name (the repo tracks
    one SLBP record, increase at D 1e-05, which stands in for the others).
    Each loader's result and its K1 launches, with K2 and K3 at zero and the
    update launches at one a K1 launch; with matplotlib, each figure
    rendered from the loaders' caches."""
    from upgdm_tpu_torch.figures import (
        fig1_model_compare as F1, fig4_model_sensitivity as F4, fig5_tipping_types as F5,
        fig6_slbp_model_analysis as F6, fig7_train_analysis as F7, fig8_train_source as F8,
        fig9_smoothing as F9, mpv_collapse as MC,
    )
    from upgdm_tpu_torch.figures.common import TRENDS, load_dynamic_record, slbp_source_path

    tmp = tmp_path_factory.mktemp("figures")
    out = SimpleNamespace(launches={}, renders={})

    def counted(name, fn):
        zero_counts()
        r = fn()
        k1, k2, k3 = kernel_counts()
        assert k2 == 0 and k3 == 0, f"{name}: K2/K3 launched {k2}/{k3} times"
        assert_updates(name, k1)
        out.launches[name] = k1
        return r

    with contextlib.chdir(REPO):
        outdir = tmp / "out"
        f1 = tmp / "demo_fig1"
        shutil.copytree(REPO / "demo_fig1", f1, ignore=shutil.ignore_patterns("figures"))
        base1 = ["--ews-root", str(f1 / "ews_results"), "--source-root", str(f1)]
        out.fig1 = counted("fig1", lambda: F1.collect_fig1_data(
            f1 / "ews_results", f1, "increase", "barabasi_albert_12_0", ("NsDiff",),
            device="cuda"))
        mc_out = outdir / "mpv_collapse"
        counted("mpv_collapse", lambda: MC.main(
            base1 + ["--output-dir", str(mc_out), "--model-name", "NsDiff", "--device", "cuda"]
            + (["--plot-checks"] if HAVE_MPL else [])))
        with open(mc_out / "mpv_collapse_samples.csv", newline="") as f:
            out.mc_rows = list(csv.DictReader(f))

        ews, src = tmp / "slbp/ews_results", tmp / "slbp/dataset"
        for bank, names in (
                ("NsDiff_pred/models", [f"dataset__w200p{p}st100" for p in F4.PRED_LENS]),
                ("NsDiff_windows/models", [f"dataset__w{w}p200st100" for w in F4.WINDOW_LENS]),
                ("NsDiff_trends/models", [F5.MODEL_NAME]),
                ("NsDiff_machine/NsDiff/models", [F6.DIFFUSION_MODEL_NAME, F9.MODEL_NAME]),
                ("NsDiff_machine/preg/models", [F6.PREG_MODEL_NAME])):
            for name in names:
                install_slbp_model(ews / bank, name)
        dirs = ([ews / "NsDiff_dataset_contant" / f for f, _ in F7.TRAIN_D_PANELS + F7.TRAIN_N_PANELS]
                + [ews / "NsDiff_machine" / f for f, _ in F7.ABLATION_PANELS]
                + [ews / "NsDiff_dataset" / f for f, _, _ in F8.MODEL_PANELS])
        for d in dirs:
            shutil.copytree(SLBP_MODEL, d)
        tracked = next((DEMO / "slbp_data").rglob("*.pt"))
        for trend in TRENDS:
            for d in FIG_NOISES:
                path = slbp_source_path(src, FIG_TT, trend, d)
                path.parent.mkdir(parents=True, exist_ok=True)
                path.symlink_to(tracked)
        series_t = load_dynamic_record(slbp_source_path(src, FIG_TT, "increase", FIG_D))
        dev = {"device": "cuda"}
        out.f4 = counted("fig4", lambda: F4.load_sensitivity_data(
            ews, src, "increase", "mpv", total_time=FIG_TT, d_value=FIG_D, **dev))
        out.f5 = counted("fig5", lambda: [F5.load_panel_data(ews, src, trend, FIG_TT, "t2e5",
                                                             FIG_D, 10, **dev)
                                          for trend in TRENDS])
        out.f6 = counted("fig6", lambda: [F6.load_panel_data(ews, src, trend, total_time=FIG_TT,
                                                             d_value=FIG_D, **dev)
                                          for trend in TRENDS])
        out.f7 = counted("fig7", lambda: (
            [F7.load_gx_panel(ews, series_t[1], series_t[0], "increase", f, t, FIG_TT, FIG_D,
                              **dev) for f, t in F7.TRAIN_D_PANELS + F7.TRAIN_N_PANELS]
            + [F7.load_ablation_panel(ews, series_t[1], series_t[0], "increase", f, t, FIG_TT,
                                      FIG_D, **dev) for f, t in F7.ABLATION_PANELS]))
        recs8 = {trend: F8.load_slbp_record(src, trend, FIG_TT, FIG_D) for trend in TRENDS}
        out.f8 = counted("fig8", lambda: [
            F8.load_mpv(ews / "NsDiff_dataset" / f, recs8[trend], trend, FIG_TT, FIG_D, **dev)
            for trend in TRENDS for f, _, _ in F8.MODEL_PANELS])
        out.f9 = counted("fig9", lambda: [F9.load_signal(ews, src, noise, "increase", smooth,
                                                         FIG_TT, **dev)
                                          for noise in FIG_NOISES for smooth in (False, True)])
        out.sweeps = {"fig4": len(F4.PRED_LENS) + len(F4.WINDOW_LENS), "fig5": len(TRENDS),
                      "fig6": len(TRENDS), "fig7": len(F7.ABLATION_PANELS), "fig8": 0,
                      "fig9": 0}
        if HAVE_MPL:  # every loader above left its caches: the renders sweep nothing
            slbp_base = ["--ews-root", str(ews), "--source-root", str(src)]
            for mod, argv in (
                    (F1, base1 + ["--graph", "barabasi_albert_12_0", "--models", "NsDiff"]),
                    (F4, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F5, slbp_base + ["--d-values", FIG_D, "--time-rows", f"{FIG_TT}:t2e5:10"]),
                    (F6, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F7, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F8, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F9, slbp_base + ["--total-time", FIG_TT])):
                name = mod.__name__.rsplit(".", 1)[1]
                counted(f"render_{name}", lambda: mod.main(
                    argv + ["--output-dir", str(outdir / name), "--device", "cuda"]))
                out.renders[name] = list((outdir / name).glob("*.png"))
    return out


@pytest.mark.card
def test_figures_fig1(figures):
    ok1 = all(finite(d["models"]["NsDiff"]["ews"]) for d in figures.fig1.values())
    assert len(figures.fig1) == 3 and ok1 and figures.launches["fig1"] > 0, (
        f"fig1: finite MPVs {ok1}, K1 launches {figures.launches['fig1']}")


@pytest.mark.card
def test_figures_mpv_collapse_as_the_jax_package(figures):
    rows = figures.mc_rows
    got_mc = {r["dynamic_type"]: (r["skip_reason"], float(r["baseline_mpv"] or "nan"))
              for r in rows}
    mc_ok = len(rows) == 3 and all(
        got_mc[k][0] == skip and (base is None or abs(got_mc[k][1] / base - 1) <= SLBP_GX_TOL)
        for k, (skip, base) in MC_EXPECTED.items())
    assert mc_ok, (f"mpv_collapse rows (skip reason, baseline MPV) {got_mc}, the JAX "
                   f"package's {MC_EXPECTED}")


@pytest.mark.card
def test_figures_fig4_to_fig9_loaders(figures):
    f = figures
    unavailable = [p["sampling"]["reason"] for p in f.f6 if not p["sampling"].get("available")]
    assert not unavailable, f"fig6: sampling unavailable: {unavailable}"
    checks = {
        "fig4": all(finite(v, SLBP_WINDOWS) for k in ("pred_ews", "win_ews")
                    for v in f.f4[k].values()),
        "fig5": all(finite(p["mpv"], SLBP_WINDOWS) for p in f.f5),
        "fig6": all(finite(p["sampling"]["mpv"], SLBP_WINDOWS)
                    and finite(p["diffusion_gx"]["gx_mpv"], SLBP_WINDOWS)
                    and finite(p["preg_gx"]["gx_mpv"], SLBP_WINDOWS)
                    and finite(p["raw_variance"]["variance"], positive=False)
                    for p in f.f6),
        "fig7": all(finite(p["mpv"], SLBP_WINDOWS)
                    and ("error" not in p or finite(p["error"], SLBP_TARGETS)) for p in f.f7),
        "fig8": all(finite(s["mpv"], SLBP_WINDOWS) for s in f.f8),
        "fig9": all(finite(s["gx_mpv"], SLBP_WINDOWS) for s in f.f9),
    }
    wrong = {k: f.launches[k] for k, n in f.sweeps.items() if f.launches[k] != n * SLBP_K1}
    assert all(checks.values()) and not wrong, (
        f"finite MPVs {checks}; K1 launches off {SLBP_K1} a sweep: {wrong}")


@pytest.mark.card
def test_figures_rendered(figures):
    if not HAVE_MPL:
        pytest.skip("matplotlib is not installed: the loaders ran, the renders did not")
    for name, pngs in figures.renders.items():
        assert len(pngs) == 1 and figures.launches[f"render_{name}"] == 0, (
            f"{name}: PNGs {pngs}, K1 launches {figures.launches[f'render_{name}']}")


# -- datagen: K4 and the data layer -----------------------------------------------------------
# K4 against its twin on the same Philox normals, element by element, over 1,000
# steps: SLBP bit for bit (the kernel rounds the twin's operations one by one in
# the same order, and both take the normals' Box-Muller transform in float64);
# the networks within K4_REL of the run's largest |state|: the product A v sums by
# FMA in node order in the kernel and in the BLAS's order in the twin (a few
# roundings of a state a step), and the neuronal sigmoid's expf is not PyTorch's
# exp; on these stable runs a step's difference decays instead of growing
# (measured on the H100: at most 5 roundings, 4.9e-7 of the scale). 2^-18 is 64
# roundings.
K4_REL = 2.0 ** -18
K4_STEPS = 1000
# the control's ramp, the initial states and the parameters of the checks: SIS
# with d 0.1 on its endemic branch at every N (eps lambda_max > d: near the
# disease-free state a state pushed below 0 runs away, which is why the
# simulators retry) and every Euler step stable (eps deg_max dt < 2; the tracked
# 100-node graph has a hub of degree 63)
K4_RAMP = {"SIS": (0.1, 0.2), "biomass": (0.0, 2.0), "neuronal": (0.0, 0.4),
           "SLBP": (0.0, 2.6)}
K4_INIT = {"SIS": (0.2, 1.0), "biomass": (5.0, 10.0), "neuronal": (0.0, 3.0)}
K4_PARAMS = {"biomass": {"r": 0.7, "k": 10.0, "d": 0.05}, "SIS": {"d": 0.1},
             "neuronal": {"tau": 2.0, "mu": 1.5}}
K4_NS = (12, 30, 100, 300)
GRAPH_DIR = REPO / "dataset/train_dataset_graph"
NET_GRAPH = "barabasi_albert_100_0"  # the tracked 100-node graph (demo_n100's too)
# the demo corpus (examples/slbp_demo.py:37, 58-61) over DEMO_SEEDS seeds; its
# transition (every 1000th bream state) against demo_artifacts/summary.json's,
# which is one draw (the JAX package's seed 0): the record must lie in the 99%
# prediction interval of the seeds, mean +- t(0.995, n-1) s sqrt(1 + 1/n), widened
# by the locator's grid (1000 steps of 0.1): the noise moves an SLBP
# transition by thousands of time units from seed to seed.
DEMO_TT, DEMO_SEEDS, DG_GRID = 2e5, range(8), 1000 * 0.1
# examples/fig1_demo.py's SIS physics and settings (total 40, burn 20, dt 0.1, seed 3)
FIG1_SIS = dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4, total_time=40.0,
                burn_time=20.0, dt=0.1, seed=3)
K4_CASES = ([f"SLBP_{noise}_save{se}" for noise in ("additive", "scale_mixture")
             for se in (1, 10)] + ["SLBP_noise_free"]
            + [f"{s}_N{N}" + sfx for N in K4_NS for s in K4_PARAMS
               for sfx in (("", "_noise_free", "_additive_save10") if N == 100 else ("",))])


def k4_adjacencies():
    """The check graphs by node count: BA 12 from ``random.Random(0)``, the
    tracked 30- and 100-node graphs, BA 300 (m 3, seed 0)."""
    from upgdm_tpu_torch.data import graphs
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency

    random.seed(0)
    return {12: graphs.gen_graph("barabasi_albert", 12, 12, rng=random.Random(0)).adj,
            30: graphml_to_adjacency(GRAPH_DIR / "barabasi_albert_30_0.graphml").adj,
            100: graphml_to_adjacency(GRAPH_DIR / f"{NET_GRAPH}.graphml").adj,
            300: graphs.generate_network("BA", 300, m=3, seed=0).adj}


@pytest.fixture(scope="module")
def k4(card):
    """K4 against its twin over the four systems at 12 to 300 nodes, both
    noise modes, save_every 1 and 10 and noise-free (a case a run), and
    three trajectories in one launch and in three segments."""
    from upgdm_tpu_torch.data import sde
    from upgdm_tpu_torch.ops.kernels.sde_scan import STREAM_RUN, sde_scan, sde_scan_reference

    dev, checks = card, {}
    rng = np.random.default_rng(0)
    adjs = k4_adjacencies()
    slbp = sde.SystemDrift("SLBP")
    sig_slbp = np.array([(2e-5) ** 0.5, (2e-6) ** 0.5], np.float32)

    def check(name, drift, y0, sig, save_every, noise, steps=K4_STEPS):
        d = drift.to(dev)
        eps = torch.linspace(*K4_RAMP[drift.system], steps, device=dev)
        args = (d, torch.as_tensor(y0, device=dev), eps, torch.as_tensor(sig, device=dev), 0.1,
                7, STREAM_RUN, 0, save_every, noise)
        y_k, ys_k = sde_scan(*args)
        y_t, ys_t = sde_scan_reference(*args)
        err = max((ys_k - ys_t).abs().max().item(), (y_k - y_t).abs().max().item())
        scale = ys_t.abs().max().item()
        ok = (ys_k.shape == (steps // save_every, len(y0)) and bool(torch.isfinite(ys_k).all())
              and (torch.equal(ys_k, ys_t) if drift.system == "SLBP" else err <= K4_REL * scale))
        checks[name] = (ok, f"K4 {name}: off its twin by {err} (scale {scale}, bar "
                            f"{'bit for bit' if drift.system == 'SLBP' else K4_REL})")

    y_slbp = np.array([30.0, 2.0], np.float32)
    for noise in ("additive", "scale_mixture"):
        for se in (1, 10):
            check(f"SLBP_{noise}_save{se}", slbp, y_slbp, sig_slbp, se, noise)
    check("SLBP_noise_free", slbp, y_slbp, 0 * sig_slbp, 1, "additive")
    for N, adj in adjs.items():
        for system, bp in K4_PARAMS.items():
            drift = sde.SystemDrift(system, adj, **bp)
            y0 = rng.uniform(*K4_INIT[system], N).astype(np.float32)
            check(f"{system}_N{N}", drift, y0, np.full(N, 0.01, np.float32), 1, "scale_mixture")
            if N == 100:
                check(f"{system}_N{N}_noise_free", drift, y0, np.zeros(N, np.float32), 1,
                      "scale_mixture")
                check(f"{system}_N{N}_additive_save10", drift, y0, np.full(N, 0.01, np.float32),
                      10, "additive")
    # two segmentations of one trajectory: equal bit for bit
    segments = {}
    for system, N in (("SLBP", 2), ("SIS", 100), ("neuronal", 300)):
        d = (slbp if system == "SLBP"
             else sde.SystemDrift(system, adjs[N], **K4_PARAMS[system])).to(dev)
        noise = "additive" if system == "SLBP" else "scale_mixture"
        y0 = torch.as_tensor(rng.uniform(0.2, 1.0, N).astype(np.float32), device=dev)
        sg = torch.full((N,), 0.01, device=dev)
        eps = torch.linspace(*K4_RAMP[system], 3000, device=dev)
        y_one, ys_one = sde_scan(d, y0, eps, sg, 0.1, 5, STREAM_RUN, 0, 1, noise)
        y, parts = y0, []
        for a, b in ((0, 1000), (1000, 1777), (1777, 3000)):
            y, ys = sde_scan(d, y, eps[a:b], sg, 0.1, 5, STREAM_RUN, a, 1, noise)
            parts.append(ys)
        cat = torch.cat(parts)
        diff = (cat != ys_one).any(dim=1).nonzero()
        segments[system] = {"equal": bool(torch.equal(cat, ys_one) and torch.equal(y, y_one)),
                            "first_step_apart": int(diff[0]) if len(diff) else None}
    return SimpleNamespace(checks=checks, segments=segments, adjs=adjs)


@pytest.mark.card
@pytest.mark.parametrize("name", K4_CASES)
def test_k4_against_its_twin(k4, name):
    ok, msg = k4.checks[name]
    assert ok, msg


@pytest.mark.card
def test_k4_segmentations_agree(k4):
    assert all(v["equal"] for v in k4.segments.values()), (
        f"K4: two segmentations of one trajectory differ: {k4.segments}")


@pytest.mark.card
def test_simulators_on_the_card_against_the_cpu(k4):
    """The same calls on the CPU (the twin, the same Philox stream): SLBP bit
    for bit, a network within K4's bar."""
    from upgdm_tpu_torch.data import sde

    slbp_kw = dict(total_time=300.0, burn_time=20.0, seed=3)
    on_card = sde.simulate_slbp(device="cuda", **slbp_kw)["ys_dynamic"]
    on_cpu = sde.simulate_slbp(device="cpu", **slbp_kw)["ys_dynamic"]
    net_kw = dict(trend="decrease", control_range=(0.0, 0.4), base_params=K4_PARAMS["neuronal"],
                  eta=0.01, total_time=40.0, burn_time=5.0, seed=2)
    net_card = sde.simulate_network_system("neuronal", k4.adjs[30], device="cuda", **net_kw)
    net_cpu = sde.simulate_network_system("neuronal", k4.adjs[30], device="cpu", **net_kw)
    card_vs_cpu = {"SLBP_bit_equal": bool(np.array_equal(on_card, on_cpu)),
                   "neuronal_N30_max_abs": float(np.abs(net_card["ys_dynamic"]
                                                        - net_cpu["ys_dynamic"]).max())}
    assert (card_vs_cpu["SLBP_bit_equal"] and card_vs_cpu["neuronal_N30_max_abs"]
            <= K4_REL * np.abs(net_cpu["ys_dynamic"]).max()), (
        f"the simulators on the card against the CPU: {card_vs_cpu}")


@pytest.fixture
def in_repo(tmp_path):
    """A temporary directory, with the repo root as the working directory
    (the tracked models' yamls load their pretrain stages from paths under
    it)."""
    with contextlib.chdir(REPO):
        yield tmp_path


def counted4(name, fn, launches):
    """fn() with the launches of (K1, K2, K3, K4) kept in ``launches[name]``
    and the update launches held to one a K1 launch."""
    zero_counts()
    r = fn()
    launches[name] = counts()[:4]
    assert_updates(name, launches[name][0])
    return r


@pytest.mark.card
def test_default_slbp_corpus(card, in_repo):
    """The JAX package's default SLBP corpus: 2 trends x D (1e-5, 5e-6), 1e6 / 0.1."""
    from upgdm_tpu_torch.data import generate
    from upgdm_tpu_torch.utils.io import load_pt

    launches = {}
    written = counted4("slbp_default", lambda: generate.generate_slbp_dataset(
        in_repo / "slbp"), launches)
    rec = load_pt(written[0])
    default_ok = (rec["ys_dynamic"].shape == (10_000_000, 2)
                  and np.isfinite(rec["ys_dynamic"]).all()
                  and rec["ts_dynamic"].shape == (10_000_000,))
    assert len(written) == 4 and default_ok and launches["slbp_default"][3] == 4 * 11, (
        f"default SLBP corpus: {len(written)} records, K4 launches {launches['slbp_default']}")


@pytest.mark.card
def test_demo_corpus_over_seeds_and_through_the_facade(card, in_repo):
    """The demo corpus over DEMO_SEEDS seeds, its transition against the
    record; the seed-0 trajectory through the facade with the demo model, as
    the slbp cases run the demo's scan."""
    from scipy.stats import t as student_t

    from upgdm_tpu_torch.data import sde
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.figures.mpv_collapse import locate_transition
    from upgdm_tpu_torch.utils.io import save_pt

    tmp, launches = in_repo, {}
    record = json.loads((DEMO / "summary.json").read_text())

    def demo_seeds():
        rec0, times = None, []
        for s in DEMO_SEEDS:
            r = sde.simulate_slbp(params={"D": 1e-5}, trend="increase", total_time=DEMO_TT,
                                  burn_time=1000.0, dt=0.1, seed=s, device="cuda")
            ts = np.asarray(r["ts_dynamic"], float)[::1000]
            times.append(locate_transition(ts, np.asarray(r["ys_dynamic"], float)[::1000, 0],
                                           "SLBP", "increase")["transition_time"])
            if s == 0:
                rec0 = r
        return rec0, times

    rec0, transitions = counted4("demo_seeds", demo_seeds, launches)
    demo_mean, demo_sd = float(np.mean(transitions)), float(np.std(transitions, ddof=1))
    demo_gap = abs(record["transition_time_state"] - demo_mean)
    n = len(transitions)
    demo_bar = float(student_t.ppf(0.995, n - 1)) * demo_sd * (1 + 1 / n) ** 0.5 + DG_GRID
    data_file = (tmp / "slbp_data" / f"SLBP_dynamic_total_time_{DEMO_TT}_N_increase"
                 / "SLBP_dynamic_D_1e-05.pt")
    save_pt(rec0, data_file)
    model_dir = tmp / "model"
    shutil.copytree(SLBP_MODEL, model_dir)
    scan = counted4("demo_scan", lambda: U.uncertainty_ews(
        model_save_file=model_dir, data_file=data_file, dynamic_type="SLBP",
        cache_path=tmp / "scan/mpv_cache.pt", nsdiff_g_path=tmp / "scan/mpv_cache_gx.pt",
        sample_window_step=10, uncertainty_method="both", chunk_windows=16,
        load_model_when_cached=True, device="cuda"), launches)
    assert (len(scan["ews"]) == SLBP_WINDOWS and finite(scan["ews"], SLBP_WINDOWS)
            and launches["demo_scan"][:3] == (SLBP_K1, 0, 0)), (
        f"generated trajectory through the facade: {len(scan['ews'])} windows, "
        f"launches {launches['demo_scan']}")
    assert demo_gap <= demo_bar, (
        f"demo corpus transition: mean {demo_mean} over seeds {transitions} is {demo_gap} "
        f"from the record's {record['transition_time_state']} (bar {demo_bar})")


@pytest.mark.card
def test_network_cli_on_the_tracked_100_node_graph(card, in_repo):
    """The network CLI at its defaults on the tracked 100-node graph. biomass
    and neuronal give their records; SIS diverges on every one of its 10
    attempts and raises, as the JAX package's CLI does on this graph (its hub
    of degree 63 makes Euler at dt 0.1 unstable on the endemic branch: eps deg
    dt > 2), so SIS runs again at examples/n100_scale_demo.py's settings (dt
    0.01, every 10th step)."""
    from upgdm_tpu_torch.data import generate, sde
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.utils.io import load_pt

    tmp, launches = in_repo, {}
    for system in ("biomass", "neuronal", "SIS"):
        def cli():
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    generate.main([system, "--out-dir", str(tmp / "net"), "--graph-dir",
                                   str(GRAPH_DIR), "--graph-filter", NET_GRAPH])
            except RuntimeError as exc:
                return str(exc)
            return None

        raised = counted4(f"net_{system}", cli, launches)
        files = sorted((tmp / "net" / NET_GRAPH).glob(f"{system}_dynamic_*.pt"))
        recs = [load_pt(f)["ys_dynamic"] for f in files]
        ok = all(r.shape == (100_000, 100) and np.isfinite(r).all() for r in recs)
        del recs
        k4n = launches[f"net_{system}"][3]
        if system == "SIS":
            assert (raised == "simulation diverged after 10 retries (SIS)" and k4n == 20
                    and not files), f"network CLI SIS: {raised!r}, {k4n} K4 launches, {files}"
        else:
            assert raised is None and len(files) == 2 and ok, (
                f"network CLI {system}: {raised!r}, {len(files)} records, finite {ok}")
    adj100 = graphml_to_adjacency(GRAPH_DIR / f"{NET_GRAPH}.graphml").adj
    sis100 = counted4("net_SIS_n100_demo", lambda: sde.simulate_network_system(
        "SIS", adj100, trend="increase", total_time=150.0, burn_time=20.0, dt=0.01,
        save_every=10, seed=7, control_range=(1e-4, 0.075), base_params={"d": 0.5},
        eta=1e-4, device="cuda"), launches)
    assert (sis100["ys_dynamic"].shape == (1500, 100)
            and np.isfinite(sis100["ys_dynamic"]).all()), (
        f"SIS at the n100 demo's settings: {sis100['ys_dynamic'].shape}")


@pytest.mark.card
def test_generated_sis_record_through_the_facade(card, in_repo):
    """A generated SIS record through the facade with the trained demo_fig1 model."""
    from upgdm_tpu_torch.data import graphs, sde
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.utils.io import save_pt

    tmp, launches = in_repo, {}
    random.seed(0)
    adj12 = graphs.gen_graph("barabasi_albert", 12, 12, rng=random.Random(0)).adj
    sis_file = tmp / "sis" / "SIS_dynamic_eta0.0001d0.5_increase.pt"
    save_pt(counted4("sis_record", lambda: sde.simulate_network_system(
        "SIS", adj12, trend="increase", device="cuda", **FIG1_SIS), launches), sis_file)
    (tmp / "sis_cache").mkdir()
    sis = counted4("sis_facade", lambda: U.uncertainty_ews(
        model_save_file=SIS_MODEL, data_file=sis_file, dynamic_type="SIS",
        cache_path=tmp / "sis_cache", cache_mode="none", device="cuda"), launches)
    assert finite(sis["ews"]) and launches["sis_facade"][0] > 0, (
        f"generated SIS record through the facade: launches {launches['sis_facade']}")


@pytest.mark.card
def test_graph_library_and_bury_corpus(card, in_repo):
    """Host work of the data layer: the graph library (read back) and the
    Bury corpus."""
    from upgdm_tpu_torch.data import bury_sim, graphs
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency

    tmp = in_repo
    graphs.generate_graph_library(tmp / "lib")
    lib = sorted((tmp / "lib").glob("*.graphml"))
    lib_ok = all(graphs.graph_properties(a, np.ones(len(a), bool), "LCC") == len(a)
                 == int(p.stem.split("_")[-2])
                 for p in lib for a in [graphml_to_adjacency(p).adj])
    bury = bury_sim.generate_bury_training_corpus(tmp / "bury")
    assert len(lib) == 120 and lib_ok and len(bury) == 96, (
        f"graph library {len(lib)} files (connected, sized: {lib_ok}), Bury corpus {len(bury)}")


# -- real_data ----------------------------------------------------------------------------------
# the real-data pipeline (eval/real_data.py, eval/bury.py) on the tracked demo_real
# record and model; the Bury classifiers' bar against the CPU is the CPU's against
# Keras (tests/test_torch_port_bury.py); g(x)'s is the JAX package's
REAL_NAME = "slbp_empirical_demo"
BURY_ATOL, REAL_GX_TOL = 1e-5, 1e-4
# the reference layout of a Linear, Conv1d and 1x1-conv FFN weight, and of a copy
# (utils/torch_import.py::_T inverted)
TO_REFERENCE = {
    "linear": lambda a: a.T.copy(),
    "conv1d": lambda a: a.transpose(2, 1, 0).copy(),
    "ffn_conv": lambda a: a.T[..., None].copy(),
    "copy": lambda a: a.copy(),
}


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def real_data(card, tmp_path_factory):
    """The real-data pipeline on the card over a temporary copy of
    ``demo_real``: the Bury CLI's ``run_one`` on the record with all 20
    classifiers, on the card and the CPU, with the classifiers' forwards;
    the signal stage of ``real_data.run_one`` (``build_signal_data`` and the
    CSV) with the five default signals on the card, again as a cache hit,
    and on the CPU, with g(x)'s forwards; ``real_systems`` where matplotlib
    is installed; the launches of every kernel over the whole run."""
    from upgdm_tpu_torch.eval import bury as B
    from upgdm_tpu_torch.eval import real_data as R
    from upgdm_tpu_torch.models.sigma_estimation import SigmaEstimation
    from upgdm_tpu_torch.utils import io as pio

    tmp = tmp_path_factory.mktemp("real_data")
    out = SimpleNamespace()
    zero_counts()
    with contextlib.chdir(REPO):
        demo = tmp / "demo_real"
        shutil.copytree(REPO / "demo_real", demo, ignore=shutil.ignore_patterns("figures"))
        out.demo = demo

        def bury_args(device):
            return SimpleNamespace(
                data_root=demo / "data", model_root=B.DEFAULT_MODEL_ROOT,
                output_root=tmp / f"bury_{device}", pred_dim=0, classifier_len=None,
                max_models=None, inc_points=10, detrend_method="lowess", detrend_span=0.2,
                detrend_bandwidth=0.2, full_prefix=False, device=device)

        fwd = Forwards(B.BuryClassifier)
        out.bury_paths = B.run_one(bury_args("cuda"), REAL_NAME)
        out.bury_forwards = fwd.n
        fwd.remove()
        out.bury_cpu_paths = B.run_one(bury_args("cpu"), REAL_NAME)
        bury_root = Path(out.bury_paths[0]).parents[1]
        record = pio.load_pt(R.resolve_real_data_path(REAL_NAME, demo / "data"))
        out.record = record

        def signals(device, tag):
            args = R.default_args(
                data_root=str(demo / "data"), real_data_result_root=str(tmp / f"res_{tag}"),
                bury_prob_root=str(bury_root), output_root=str(tmp / f"fig_{tag}"),
                model_dir=str(demo / "model"), device=device)
            rows = R.build_signal_data(dict(record), REAL_NAME, args)[3]
            stem = R.output_stem(REAL_NAME, args)
            return args, R.write_signal_table(rows, f"{stem}_signals.csv")

        gfwd = Forwards(SigmaEstimation)
        args_card, out.csv_card = signals("cuda", "card")
        out.fresh_forwards, gfwd.n = gfwd.n, 0
        out.csv_hit = signals("cuda", "card")[1]
        out.hit_forwards = gfwd.n
        gfwd.remove()
        out.csv_cpu = signals("cpu", "cpu")[1]
        if HAVE_MPL:
            from upgdm_tpu_torch.figures import real_systems

            real_systems.main([
                "--data-real-names", REAL_NAME, "--output-dir", str(tmp / "composite"),
                "--data-root", str(demo / "data"),
                "--real-data-result-root", args_card.real_data_result_root,
                "--bury-prob-root", str(bury_root),
                "--model-dir", str(demo / "model"), "--device", "cuda"])
    out.launches = counts()
    return out


@pytest.mark.card
def test_bury_classifiers_against_the_cpu(real_data):
    from upgdm_tpu_torch.eval import bury as B

    got, want = csv_rows(real_data.bury_paths[0]), csv_rows(real_data.bury_cpu_paths[0])
    assert got[0] == want[0] == B.TABLE_COLUMNS and len(got) == len(want) > 1, (
        f"Bury CSV header {got[0]} / {len(got)} rows, CPU {len(want)}")
    g, w = np.asarray(got[1:], float), np.asarray(want[1:], float)
    bury_err = float(np.abs(g[:, 1:] - w[:, 1:]).max())
    row_sum = float(np.abs(g[:, 1:5].sum(1) - 1).max())
    assert np.array_equal(g[:, 0], w[:, 0]) and bury_err <= BURY_ATOL and row_sum <= BURY_ATOL, (
        f"Bury probabilities: card off the CPU by {bury_err}, rows off 1 by {row_sum} "
        f"(bar {BURY_ATOL})")
    meta = json.loads(real_data.bury_paths[2].read_text())
    assert real_data.bury_forwards == meta["num_classifiers"] == 20, (
        f"{real_data.bury_forwards} classifier forwards for {meta['num_classifiers']} "
        f"classifiers")


@pytest.mark.card
def test_signal_stage_against_the_cpu_and_its_cache(real_data):
    from upgdm_tpu_torch.eval import real_data as R

    got, want = csv_rows(real_data.csv_card), csv_rows(real_data.csv_cpu)
    assert got == csv_rows(real_data.csv_hit), "the cache hit wrote other rows"
    assert got[0] == want[0] == R.SIGNAL_COLUMNS and len(got) == len(want), (
        f"signal CSV header {got[0]}, {len(got)} rows against the CPU's {len(want)}")
    rows, model_err, exact = {}, 0.0, True
    for a, b in zip(got[1:], want[1:]):
        assert a[:4] == b[:4], f"signal rows differ: {a} / {b}"
        rows[a[1]] = rows.get(a[1], 0) + 1
        if a[1] in ("model_uncertainty", "model_trend"):
            va, vb = float(a[4]), float(b[4])
            model_err = max(model_err, abs(va - vb) / (REAL_GX_TOL + REAL_GX_TOL * abs(vb)))
        else:
            exact = exact and a[4] == b[4]
    assert (model_err <= 1.0 and exact and rows.get("model_uncertainty", 0) > 0
            and set(rows) == {"trajectory", "model_uncertainty", "model_trend", "ar1",
                              "variance", "bury_ml"}), (
        f"signals: model rows at {model_err} of the bar (atol = rtol = {REAL_GX_TOL}), "
        f"other rows equal: {exact}, rows {rows}")
    assert real_data.fresh_forwards > 0 and real_data.hit_forwards == 0, (
        f"g(x) forwards: {real_data.fresh_forwards} fresh, {real_data.hit_forwards} on the "
        f"cache hit")


@pytest.mark.card
def test_reference_checkpoint_through_load_state_dict(real_data):
    """A reference-format NsDiff dict built from the demo model, loaded on
    the card: its g(x) equal to the native model's."""
    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.eval.uncertainty import load_model_from_dir
    from upgdm_tpu_torch.utils.torch_import import nsdiff_reference_key_map

    with contextlib.chdir(REPO):
        native, net_param = load_model_from_dir(real_data.demo / "model", device="cuda",
                                                use_cache=False)
    flat = native.state_dict()
    key_map = nsdiff_reference_key_map(
        int(net_param.get("e_layers", 2)), int(net_param.get("d_layers", 1)),
        int(net_param.get("p_hidden_layers", 2)))
    ref = {tk: TO_REFERENCE[tf](flat[fk]) for tk, (fk, tf) in key_map.items()}
    ref.update(scaler_mean=flat["scaler_mean"], scaler_std=flat["scaler_std"])
    imported = diffusion_models(task_model="NsDiff", net_param=net_param, seed=1, device="cuda")
    imported.load_state_dict(ref)
    series = np.asarray(real_data.record["ys_dynamic"], np.float32)[:, :1].T[:, :, None]
    wins = np.stack([series[:, i : i + 100] for i in range(0, 300, 10)])  # [30, 1, 100, 1]
    xw = torch.from_numpy(wins.reshape(-1, 100, 1)).cuda()
    with torch.no_grad():
        gx_native, gx_imported = native.gx_fn(xw), imported.gx_fn(xw)
    same_keys = sorted(imported.state_dict()) == sorted(flat)
    assert same_keys and torch.equal(gx_native, gx_imported), (
        f"reference checkpoint: keys equal {same_keys}, g(x) off by "
        f"{(gx_native - gx_imported).abs().max().item()}")


@pytest.mark.card
def test_real_data_launches_no_kernel(real_data):
    assert real_data.launches == (0, 0, 0, 0, 0), (
        f"kernel launches K1-K4 and the update {real_data.launches}: none is on this path")


# -- multi_gpu: the port's torch.distributed layer on the one card ------------------------------
MG_REPS = 3  # sweeps of each kind from the same seed: all bit for bit equal
MG_DEADLINE_S = 300.0
# two gloo ranks on one card against one NCCL rank: the card's f/g matmuls run
# at other row counts, so per-window MPV at the bar of the kernel chains' two
# arms (1%); the step at the card-vs-CPU bars
MG_MPV_REL = 0.01


@pytest.fixture(scope="module")
def multi_gpu(card, tmp_path_factory):
    """A process group of one NCCL rank at a file store with its mesh; the
    NsDiff sweep at the bench geometry through ``sharded_fast_mpv_sweep`` and
    ``fast_mpv_sweep`` from one seed, MG_REPS times each, with their K1 and
    update launches; ``sharded_window_ensemble`` and
    ``batched_window_ensemble``; TMDM through both sweeps with its K3
    launches; the data-parallel step at the train-bench geometry over NCCL
    and the plain step; ``run_training`` with and without ``dataparallel``
    under the group; two gloo ranks on cuda:0 (NCCL refuses two ranks on one
    card); ``parallel_grid_search`` and ``grid_search`` over a
    2-configuration grid. The group is destroyed at the end."""
    import torch.distributed as dist

    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.cli.train_driver import grid_search, parallel_grid_search
    from upgdm_tpu_torch.eval.uncertainty import batched_window_ensemble, fast_mpv_sweep
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.parallel.data_parallel import (
        sharded_fast_mpv_sweep, sharded_window_ensemble,
    )
    from upgdm_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed, spawn_ranks
    from upgdm_tpu_torch.train.loop import deterministic_cudnn, run_training
    from upgdm_tpu_torch.utils.io import load_checkpoint, read_model_config

    tmp = tmp_path_factory.mktemp("multi_gpu")
    out = SimpleNamespace()
    try:
        out.started = maybe_init_distributed(init_method=f"file://{tmp / 'store'}",
                                             world_size=1, rank=0)
        mesh = make_mesh()
        out.backend, out.mesh = dist.get_backend(), mesh

        model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
        wins = make_windows(N_WINDOWS)
        out.runs = {"sharded": [], "fast": []}
        sweeps = {"sharded": lambda: sharded_fast_mpv_sweep(model, wins, PRED_LEN, mesh, CHUNK),
                  "fast": lambda: fast_mpv_sweep(model, wins, PRED_LEN, chunk_windows=CHUNK,
                                                 device="cuda")}
        for _ in range(MG_REPS):
            for kind in ("sharded", "fast"):
                model.generator.manual_seed(MG_SEED)
                zero_counts()
                mpv_pm = sweeps[kind]()
                out.runs[kind].append((mpv_pm, counts()))

        out.ens = {}
        for kind, fn in (("sharded", lambda: sharded_window_ensemble(
                model, wins[:CHUNK], PRED_LEN, mesh, CHUNK)),
                         ("batched", lambda: batched_window_ensemble(
                model, wins[:CHUNK], PRED_LEN, chunk_windows=CHUNK, device="cuda"))):
            model.generator.manual_seed(MG_SEED + 1)
            out.ens[kind] = fn()
        del model

        tmdm = diffusion_models("TMDM", TMDM_PARAM, seed=0, device="cuda")
        twins = make_windows(T_WINDOWS)
        out.tm = {}
        for kind, fn in (("sharded", lambda: sharded_fast_mpv_sweep(
                tmdm, twins, PRED_LEN, mesh, T_CHUNK)),
                         ("fast", lambda: fast_mpv_sweep(tmdm, twins, PRED_LEN,
                                                         chunk_windows=T_CHUNK, device="cuda"))):
            tmdm.generator.manual_seed(MG_SEED)
            zero_counts()
            out.tm[kind] = (fn(), kernel_counts()[2])
        del tmdm

        batch = np.random.default_rng(3).normal(
            size=(MG_TRAIN_B, WINDOWS + PRED_LEN, 1)).astype(np.float32)
        tb = torch.as_tensor(batch, device="cuda")
        with deterministic_cudnn():
            plain, _, out.plain_losses, _ = dp_train_steps(None, tb)
            dp, _, out.dp_losses, out.dp_grads = dp_train_steps(mesh, tb)
            out.same_w = all(np.array_equal(a, b) for a, b in zip(
                plain.state_dict().values(), dp.state_dict().values()))
        del plain, dp

        tr, va, dataset_param = demo_split()
        net = dict(read_model_config(DEMO / "pre_model_F/trained_model")["net"],
                   load_pretrain=False)
        opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
        base = dict(train_model_select="pretrain_f", train_batch_size=32, val_batch_size=len(va),
                    test_set=True, ckpt=False, train_epochs=3)
        out.recs = {}
        for kind, extra in (("plain", {}), ("dataparallel", {"dataparallel": True})):
            out.recs[kind] = run_training(tr, va, dict(base, **extra), dict(net),
                                          {"loss_metric": "KL divergence"}, opt, tmp / kind,
                                          dataset_param=dataset_param, device="cuda")
        out.ckpts = [load_checkpoint(tmp / k / "trained_model/model_trained")[1]
                     for k in out.recs]

        torch.cuda.empty_cache()  # the ranks' memory comes from the same card
        out.ranks = spawn_ranks(two_rank_check, 2, (batch, N_WINDOWS), backend="gloo",
                                device="cuda", deadline_s=MG_DEADLINE_S)

        grid_data = {k: [v] for k, v in dataset_param.items()}
        grid_train = {k: [v] for k, v in dict(base, traindata_size=0.9,
                                              model_evaluation="hold_out").items()}
        grid_net = {k: [v] for k, v in net.items()}
        grid_opt = dict({k: [v] for k, v in opt.items()}, lr=[1e-3, 5e-4])
        sections = (grid_data, grid_train, grid_net, {"loss_metric": ["KL divergence"]},
                    grid_opt)
        out.par = parallel_grid_search(*sections, tmp / "par", grid_dataset, processes=2,
                                       device="cuda")
        grid_search(*sections, tmp / "seq", grid_dataset, hp_analysis_root=tmp / "hp",
                    device="cuda")
        out.seq = json.loads(next((tmp / "seq").rglob("configs_record_scores.json")).read_text())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


@pytest.mark.card
def test_multi_gpu_group(multi_gpu):
    mesh = multi_gpu.mesh
    assert (multi_gpu.started and multi_gpu.backend == "nccl" and mesh.world_size == 1
            and mesh.device.type == "cuda"), (
        f"group: started {multi_gpu.started}, backend {multi_gpu.backend}, mesh {mesh}")


@pytest.mark.card
def test_multi_gpu_sharded_sweep_is_the_fast_sweep(multi_gpu):
    n_blocks = -(-N_WINDOWS // CHUNK)
    (mpv_b, pm_b), _ = multi_gpu.runs["fast"][0]
    for kind, rs in multi_gpu.runs.items():
        for _, c in rs:
            assert c[4] == c[0], (
                f"the {kind} sweep: the chain's update launched {c[4]} times, expected {c[0]}")
        assert all(c[0] == STEPS * n_blocks for _, c in rs), (
            f"{kind} sweep: K1 launched {[c[0] for _, c in rs]}, expected {STEPS * n_blocks}")
        assert all(np.array_equal(m[0], mpv_b) and np.array_equal(m[1], pm_b) for m, _ in rs), (
            f"{kind} sweep at world size 1 not bit for bit the fast sweep's")
    assert mpv_b.shape == (N_WINDOWS,) and np.isfinite(mpv_b).all() and (mpv_b > 0).all(), (
        f"bad MPV {mpv_b[:4]}")


@pytest.mark.card
def test_multi_gpu_window_ensemble(multi_gpu):
    ens = multi_gpu.ens
    assert len(ens["sharded"]) == len(ens["batched"]) == CHUNK and all(
        a.shape == (NODE, PRED_LEN, 1, N_Z) and np.array_equal(a, b)
        for a, b in zip(ens["sharded"], ens["batched"])), (
        "sharded_window_ensemble is not batched_window_ensemble bit for bit")


@pytest.mark.card
def test_multi_gpu_tmdm_sweep(multi_gpu):
    tm = multi_gpu.tm
    want_k3 = T_STEPS * -(-T_WINDOWS // T_CHUNK)
    equal = [np.array_equal(a, b) for a, b in zip(tm["sharded"][0], tm["fast"][0])]
    assert tm["sharded"][1] == tm["fast"][1] == want_k3 and all(equal), (
        f"TMDM: K3 {tm['sharded'][1]} / {tm['fast'][1]} (expected {want_k3}), bit for bit "
        f"{equal}")


@pytest.mark.card
def test_multi_gpu_dp_step_is_the_plain_step(multi_gpu):
    assert multi_gpu.plain_losses == multi_gpu.dp_losses and multi_gpu.same_w, (
        f"dp step at world size 1: losses {multi_gpu.dp_losses} vs {multi_gpu.plain_losses}, "
        f"weights equal {multi_gpu.same_w}")


@pytest.mark.card
def test_multi_gpu_run_training_dataparallel(multi_gpu):
    recs, ckpts = multi_gpu.recs, multi_gpu.ckpts
    same_ckpt = ckpts[0].keys() == ckpts[1].keys() and all(
        np.array_equal(ckpts[0][k], ckpts[1][k]) for k in ckpts[0])
    assert recs["plain"] == recs["dataparallel"] and same_ckpt, (
        f"run_training with the flag: records equal {recs['plain'] == recs['dataparallel']}"
        f", checkpoint equal {same_ckpt}")


@pytest.mark.card
def test_multi_gpu_two_gloo_ranks(multi_gpu):
    ranks, dp_losses, dp_grads = multi_gpu.ranks, multi_gpu.dp_losses, multi_gpu.dp_grads
    mpv_b = multi_gpu.runs["fast"][0][0][0]
    mpv_g = ranks[0]["mpv"]
    same_ranks = all(np.array_equal(r["mpv"], mpv_g) and r["losses"] == ranks[0]["losses"]
                     for r in ranks)
    gap = float(np.max(np.abs(mpv_g - mpv_b) / mpv_b))
    loss_rel = float(np.max(np.abs(np.subtract(ranks[0]["losses"], dp_losses))
                            / np.abs(dp_losses)))
    top = max(np.abs(g).max() for g in dp_grads.values())
    for k, g in dp_grads.items():
        err = float(np.abs(ranks[0]["grads"][k] - g).max())
        if k.endswith(".key.bias"):  # zero in exact arithmetic: rounding only
            assert max(np.abs(g).max(), np.abs(ranks[0]["grads"][k]).max()) \
                <= TRAIN_GRAD_ZERO * top, f"gradient {k} not zero"
            continue
        bar = float(TRAIN_GRAD_REL * np.abs(g).max())
        assert err <= bar, f"2 ranks: gradient {k} off by {err} > {bar}"
    want_k1 = STEPS * -(-N_WINDOWS // (2 * MG_CHUNK_2))
    assert (same_ranks and gap <= MG_MPV_REL and loss_rel <= TRAIN_LOSS_RTOL
            and all(r["k1_launches"] == want_k1 for r in ranks)), (
        f"2 ranks: ranks agree {same_ranks}, MPV gap {gap}, loss rel {loss_rel}, K1 "
        f"{[r['k1_launches'] for r in ranks]} (expected {want_k1} each)")


@pytest.mark.card
def test_multi_gpu_parallel_grid_search(multi_gpu):
    par, seq = multi_gpu.par, multi_gpu.seq
    assert sorted(par) == ["config_0", "config_1"] and par == seq, (
        f"parallel_grid_search records {par} vs grid_search {seq}")


# -- examples: the experiment drivers of examples/ through the port -----------------------------
# the transitions of eight seeds of the SLBP demo corpus measured on the H100
# (PERF.md): the transition of a freshly generated demo trajectory lies in their
# 99% prediction interval, mean +- t(0.995, 7) sd sqrt(1 + 1/8)
EX_DEMO_MEAN, EX_DEMO_SD, EX_DEMO_N = 178012.6, 3823.0, 8
EX_DROP_MIN = 50.0  # both arms' pre-transition MPV drop (the record: 71.4 and 72.0)
# the zoo's Fig-1 chain at full width, cut in depth to fit the card's run: one
# BA-30 graph a dynamics, one epoch, at most 64 windows a flat family; the DiffSTG
# and DiffusionTS arms on their trajectory's first chunk of windows (a window: the
# cache runner's unit, and DiffusionTS's 32-row chunk holds one 30-node window),
# DiffusionTS with its published ensemble of 100 samples
EX_GRAPH = "barabasi_albert_30_0"
EX_MAX_WINDOWS, EX_SLOW_ARM_WINDOWS = 64, 1
# the zoo's one figure job that the Fig-1 tree schedules besides fig1 itself
# (whose DiffusionTS arms sweep every window): fig3 over the three d512 NsDiffs
EX_ZOO_FIGURE = "upgdm_tpu_torch.figures.fig3_dynamics_transfer"
EX_RANDOM_SEED = 0  # the global `random` state each driver starts from
# statistics tables with a row a valid sample's group or slope: their rows
# follow the run's noise, and are held to the tracked tables' only when as
# many samples are valid as in the tracked run
EX_BY_VALID = ("mpv_collapse_summary.csv", "mpv_slope_lead_time.csv")
CUDA = ["--device", "cuda"]


def csv_head_and_rows(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], len(lines) - 1


def valid_samples(path):
    """The rows of an ``mpv_collapse`` samples CSV with no skip reason."""
    with open(path, newline="") as f:
        return sum(1 for r in csv.DictReader(f) if not r["skip_reason"])


def driven(name, fn, launches, spatial_steps=0):
    """A driver's call with its launches of (K1, K2, K3, K4, update) kept in
    ``launches[name]``: one update launch a chain step, a K1 launch on the
    flat NsDiff paths, plus ``spatial_steps`` of NsDiff_spatial chains (no
    K1). The drivers draw their graphs' edges from the global `random`, as the
    JAX drivers do (networkx's seed=None): pinned here so that a run repeats
    whatever ran before it (the paper demo's SIS at dt 0.1 on its 70-node
    small-world graph is at the edge of Euler's stability, 0.5 x lambda_max
    44.1 x 0.1 = 2.2: it diverged in 2 of 10 unpinned whole runs of the demo
    on the H100)."""
    random.seed(EX_RANDOM_SEED)
    zero_counts()
    r = fn()
    launches[name] = counts()
    assert_updates(name, launches[name][0] + spatial_steps(r) if spatial_steps else
                   launches[name][0])
    return r


@pytest.mark.card
def test_slbp_demo_at_its_defaults(card, in_repo):
    """The SLBP demo stage by stage: its summary has the demo record's keys,
    its transition lies in the demo corpus's seeds' interval, both arms
    drop before it."""
    from scipy.stats import t as student_t

    from upgdm_tpu_torch.examples import slbp_demo

    launches, slbp = {}, in_repo / "slbp"
    for stage in ("data", "train", "scan"):
        summary = driven(f"slbp_{stage}", lambda: slbp_demo.main(
            ["--out-dir", str(slbp), "--stage", stage] + CUDA), launches)
    record = json.loads((DEMO / "summary.json").read_text())
    half = float(student_t.ppf(0.995, EX_DEMO_N - 1)) * EX_DEMO_SD * (1 + 1 / EX_DEMO_N) ** 0.5
    tr = summary["transition_time_state"]
    drops = {arm: summary[arm]["pre_transition_drop_percent"]
             for arm in ("sampling_mpv", "gx_mpv")}
    keys_ok = (summary.keys() == record.keys() and all(
        summary[a].keys() == record[a].keys() for a in ("sampling_mpv", "gx_mpv")))
    assert (summary["n_windows"] == 191 and abs(tr - EX_DEMO_MEAN) <= half
            and all(d >= EX_DROP_MIN for d in drops.values()) and keys_ok
            and launches["slbp_data"][3] > 0 and launches["slbp_scan"][0] > 0), (
        f"slbp_demo: {summary['n_windows']} windows, transition {tr} (interval {EX_DEMO_MEAN} "
        f"+- {half}), drops {drops}, keys {keys_ok}, launches {launches}")


@pytest.mark.card
@pytest.mark.parametrize("name, tracked", (("fig1_demo", "demo_fig1"),
                                           ("network_stats_demo", "demo_network"),
                                           ("real_data_demo", "demo_real")))
def test_demo_at_its_defaults_against_the_tracked_tree(card, in_repo, name, tracked):
    """The tree (every file that is not an image) against the tracked one,
    each CSV's header and rows; the real-data demo's empirical record and
    its trajectory and classic-EWS rows against the tracked ones."""
    import importlib

    from upgdm_tpu_torch.utils.io import load_pt

    mod = importlib.import_module(f"upgdm_tpu_torch.examples.{name}")
    launches, out = {}, in_repo / name
    driven(name, lambda: mod.main(["--out-dir", str(out)] + CUDA), launches)
    got, want = artifact_names(out, like=REPO / tracked), artifact_names(REPO / tracked)
    csvs = {r: (csv_head_and_rows(out / r), csv_head_and_rows(REPO / tracked / r))
            for r in want if r.endswith(".csv") and (out / r).exists()}
    valid = {k: valid_samples(root / r) for k, root in (("port", out), ("tracked", REPO / tracked))
             for r in want if r.endswith("mpv_collapse_samples.csv")}
    held = {r: v for r, v in csvs.items()
            if valid.get("port") == valid.get("tracked") or not r.endswith(EX_BY_VALID)}
    assert (got == want and all(a[0] == b[0] for a, b in csvs.values())
            and all(a[1] == b[1] for a, b in held.values())), (
        f"{name}: files {got} against the tracked {want}; CSV (header, rows) "
        f"{ {r: v for r, v in csvs.items() if v[0] != v[1]} }")
    if name == "fig1_demo":
        assert launches[name][0] > 0 and launches[name][3] > 0, f"launches {launches}"
    elif name == "network_stats_demo":
        assert launches[name][3] > 0, f"launches {launches}"
    else:
        rec = load_pt(out / "data/slbp_empirical_demo.pt")
        ref = load_pt(REPO / "demo_real/data/slbp_empirical_demo.pt")
        rec_same = sorted(rec) == sorted(ref) and all(
            np.array_equal(rec[k], ref[k]) if isinstance(ref[k], np.ndarray)
            else rec[k] == ref[k] for k in ref)
        csv_rel = "figures/slbp_empirical_demo/slbp_empirical_demo_real_data_ews_signals.csv"
        rows = {k: [r for r in (root / csv_rel).read_text().splitlines()
                    if r.split(",")[1] in ("trajectory", "ar1", "variance")]
                for k, root in (("port", out), ("tracked", REPO / "demo_real"))}
        assert rec_same and rows["port"] == rows["tracked"] and len(rows["port"]) > 0, (
            f"real_data_demo: record equal {rec_same}, classic rows equal "
            f"{rows['port'] == rows['tracked']}")


@pytest.mark.card
def test_zoo_fig1_chain_at_full_width(card, in_repo, monkeypatch):
    """The zoo's Fig-1 chain at full width and cut depth (EX_GRAPH only, each
    dynamics; one epoch a model; at most EX_MAX_WINDOWS windows a
    TMDM/DiffusionTS model; DiffSTG and DiffusionTS arms on
    EX_SLOW_ARM_WINDOWS window; the figure stage runs the fig3 job only):
    data, the d512 NsDiffs, the TMDM/DiffusionTS/DiffSTG compare models, the
    arm driver over the NsDiff and TMDM SIS arms (K1, K3), the DiffSTG and
    DiffusionTS SIS arms, the corpus statistics, ``summarize`` and the fig3
    job through the zoo's figure stage (a subprocess)."""
    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.examples import fig1_arm_driver, reference_zoo
    from upgdm_tpu_torch.figures.common import dynamics_filename, graph_file, spdata_source_path

    launches, zoo = {}, in_repo / "zoo"
    monkeypatch.setattr(reference_zoo, "CORPUS_GRAPHS", [EX_GRAPH])
    monkeypatch.setattr(reference_zoo, "COMPARE_TRAIN", {
        fam: dict(tp, epochs=1, **({"max_windows": EX_MAX_WINDOWS} if "max_windows" in tp else {}))
        for fam, tp in reference_zoo.COMPARE_TRAIN.items()})
    driven("zoo_data", lambda: reference_zoo.gen_data(zoo, fig1_only=True, device="cuda"),
           launches)
    driven("zoo_models", lambda: reference_zoo.train_models(
        zoo, 1, generalization_only=True, device="cuda"), launches)
    driven("zoo_compare", lambda: reference_zoo.train_compare_models(zoo, device="cuda"),
           launches)
    ews, src = zoo / "ews_results", zoo / "dataset"
    driven("zoo_arms", lambda: fig1_arm_driver.main(
        ["--ews-root", str(ews), "--source-root", str(src), "--graph", EX_GRAPH,
         "--arms", "NsDiff:SIS", "TMDM:SIS"] + CUDA), launches)
    sis = spdata_source_path(src, "SIS", EX_GRAPH, dynamics_filename("SIS", "increase"))
    arms = {}
    for fam in ("DiffSTG", "DiffusionTS"):
        model_dir = ews / "model_compare" / fam / "SIS"
        r = driven(f"zoo_{fam}", lambda: uncertainty_ews(
            model_save_file=model_dir, data_file=sis, dynamic_type="SIS",
            task_model=fam if fam == "DiffSTG" else None,
            graph_file=graph_file(src, EX_GRAPH) if fam == "DiffSTG" else None,
            cache_path=model_dir, max_windows=EX_SLOW_ARM_WINDOWS, device="cuda"), launches)
        arms[fam] = [float(v) for v in np.asarray(r["ews"])]
    driven("zoo_stats", lambda: reference_zoo.run_stats(zoo, attempts=1, device="cuda"),
           launches)
    corpus = reference_zoo.summarize(zoo)
    jobs = [j for j in reference_zoo.figure_jobs(zoo)
            if j[0] == EX_ZOO_FIGURE and "increase" in j[1]]
    failed = driven("zoo_figure", lambda: reference_zoo.render_figures(
        zoo, jobs, attempts=1, device="cuda"), launches)
    n_systems = len(reference_zoo.SYSTEMS)
    fig_log = zoo / "figures" / (EX_ZOO_FIGURE.rsplit(".", 1)[-1] + ".log")
    fig_log = fig_log.read_text() if fig_log.exists() else ""
    figure_done = failed == 0 and ("the render is skipped" in fig_log or "saved: " in fig_log)
    arm_sidecars = {arm: fig1_arm_driver.arm_complete(ews, arm, "SIS", "increase")
                    for arm in ("NsDiff", "TMDM")}
    assert (all(arm_sidecars.values()) and launches["zoo_arms"][0] > 0
            and launches["zoo_arms"][2] > 0 and launches["zoo_data"][3] > 0
            and all(len(v) == EX_SLOW_ARM_WINDOWS and finite(v) for v in arms.values())
            and corpus["n_files"] == 2 * n_systems and len(jobs) == 1 and figure_done), (
        f"zoo: arms complete {arm_sidecars}, launches {launches}, slow arms {arms}, corpus "
        f"files {corpus['n_files']}, figure jobs {jobs} (failed {failed}; log tail "
        f"{fig_log[-600:]!r})")
    assert not any(c[1] for c in launches.values()), (
        f"K2 launched on the drivers' paths: {launches}")


@pytest.mark.card
def test_n100_and_paper_demos_at_cut_depth(card, in_repo, monkeypatch):
    """The 100-node demo at 1 epoch a model (default 3) and a scan window
    every 100 points (default 50), and the paper-figure demo on SLBP records
    of 200,000 time units only (default 200k/300k/400k, figures on 400k): cut
    to fit the card's run."""
    from upgdm_tpu_torch.examples import n100_scale_demo, paper_figures_demo

    launches = {}
    # the 100-node demo's NsDiff_spatial chains take their 20 update launches a
    # scanned window with no K1
    n100 = driven("n100_scale_demo", lambda: n100_scale_demo.main(
        ["--out-dir", str(in_repo / "n100"), "--epochs", "1", "--scan-step", "100"] + CUDA),
        launches, spatial_steps=lambda r: 20 * r["NsDiff_spatial"]["n_scan_windows"])
    paper = in_repo / "paper"
    for name, value in (("SLBP_TOTALS", ("200000.0",)), ("SLBP_MAIN_TOTAL", "200000.0"),
                        ("FIG5_TIME_ROWS", ("200000.0:t2e5:10",))):
        monkeypatch.setattr(paper_figures_demo, name, value)
    for stage in ("data", "models", "figures"):
        driven(f"paper_{stage}", lambda: paper_figures_demo.main(
            ["--out-dir", str(paper), "--stage", stage] + CUDA), launches)
    assert (all(n100[t]["n_scan_windows"] > 0 for t in ("NsDiff_spatial", "DiffSTG"))
            and launches["n100_scale_demo"][3] > 0 and launches["paper_data"][3] > 0
            and launches["paper_figures"][0] > 0), f"n100/paper: {n100}, launches {launches}"
    assert not any(c[1] for c in launches.values()), (
        f"K2 launched on the drivers' paths: {launches}")
