"""The port's SLBP analyses against the JAX package's (CPU).

The rolling variances, the SLBP windows, the summarizers, the shape
predicates and the cache paths are held to JAX's on seeded inputs. The six
analyses run the tracked, trained demo model (``demo_artifacts/model``: NsDiff,
d_model 64, F 2, W/P 100/100) laid into a ``models/<name>`` tree, over the
first windows of the tracked SLBP trajectory. Sampling is compared on JAX's
own normals (``_port_on_jax_normals``) at a small n_z in float32, so what is
left is the port's arithmetic against JAX's; gx is deterministic. Each
package writes into a tree of its own, and each reads the other's caches.
"""
import json
import shutil
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_facade import _port_on_jax_normals
from upgdm_tpu.eval import uncertainty as J
from upgdm_tpu.ops import rolling as JR
from upgdm_tpu.ops import windows as JW
from upgdm_tpu_torch.eval import uncertainty as P
from upgdm_tpu_torch.ops import rolling as PR
from upgdm_tpu_torch.ops import windows as PW
from upgdm_tpu_torch.utils.io import load_pt, load_tensor_list, save_tensor_list
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
MODEL = REPO / "demo_artifacts/model"
DATA = next((REPO / "demo_artifacts/slbp_data").rglob("*.pt"))
NAME = "dataset__w100p100st100"  # the legacy single-underscore name differs
LEGACY = "dataset_w100p100st100"
N_WIN = 3
SMALL = {"n_z_samples": 4, "sampling_dtype": "float32"}
# g(x) against JAX (tests/test_torch_parity.py); a sampled chain on the same
# normals against JAX's, float32 with sums in another order
GX_TOL = 1e-4
SAME_NORMALS_REL = 1e-4


def var_tol(windows, x):
    """E[x^2] - E[x]^2 of float32 windows on both sides, summed in orders
    that may differ: a sum of n terms in any order is within (n - 1) u
    sum|x_i| of the exact one (u = 2^-24), so each side's E[x^2] and E[x]^2
    are within ~3 n u max(x^2) and the two sides within 8 n u of the largest
    mean square."""
    return 8 * windows * 2.0 ** -24 * float(np.max(np.asarray(x, np.float64) ** 2))


@pytest.fixture(scope="module")
def traj():
    rec = load_pt(DATA)
    return np.asarray(rec["ys_dynamic"]), np.asarray(rec["ts_dynamic"])


def _tree(root):
    models = Path(root) / "models"
    models.mkdir(parents=True)
    shutil.copy(MODEL / "model_trained", models / NAME)
    shutil.copy(MODEL / "model_trained.yaml", models / f"{NAME}.yaml")
    return Path(root)


@pytest.fixture(scope="module")
def swept(tmp_path_factory, traj):
    """Each package's sensitivity sweep and gx analysis of the first N_WIN
    windows, each in a tree of its own (the port on JAX's normals)."""
    series, t = traj
    roots = {k: _tree(tmp_path_factory.mktemp(k)) for k in ("jax", "port")}
    kw = dict(data_trend="increase", max_windows=N_WIN, infer_params=dict(SMALL))
    out = {"roots": roots}
    out["j_sens"] = J.slbp_sensitivity_ews(roots["jax"], NAME, series, t, **kw)
    out["j_gx"] = J.slbp_gx_analysis(roots["jax"], NAME, series, t, **kw)
    with _port_on_jax_normals():
        out["p_sens"] = P.slbp_sensitivity_ews(roots["port"], NAME, series, t, device="cpu", **kw)
    out["p_gx"] = P.slbp_gx_analysis(roots["port"], NAME, series, t, device="cpu", **kw)
    return out


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 2, 5, 8, 51])
def test_wv_sigma_matches_jax(window):
    rng = np.random.default_rng(window)
    x = (rng.normal(size=(3, 120, 2)) * 0.3 + 2.0).astype(np.float32)
    got = PR.wv_sigma(torch.from_numpy(x), window).numpy()
    want = np.asarray(JR.wv_sigma(jnp.asarray(x), window))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=var_tol(window, x))


@pytest.mark.parametrize("step", [1, 3, 10])
def test_window_variance_1d_matches_jax(step):
    rng = np.random.default_rng(step)
    x = (rng.normal(size=2000) * 0.2 + 1.5).astype(np.float32)
    for windows in (1, 7, 100, 2000, 2001):
        got = PR.window_variance_1d(torch.from_numpy(x), windows, step).numpy()
        want = np.asarray(JR.window_variance_1d(jnp.asarray(x), windows, step))
        assert got.shape == want.shape, (windows, step)
        np.testing.assert_allclose(got, want, rtol=0, atol=var_tol(windows, x))


@pytest.mark.parametrize("geometry", [
    (2000, 100, 100, 100, 10),  # the demo's: 191 input windows, 181 targets
    (300, 16, 8, 0.1, 7),
    (120, 100, 30, 0.1, 5),     # too short for a target: [0, pred_len, F]
    (50, 16, 8, 10, 3),         # decimated by 100
])
def test_slbp_sensitivity_windows_bit_for_bit(geometry):
    T, windows, pred_len, sampling_t, step = geometry
    rng = np.random.default_rng(T)
    # T points after decimation by the sampling period
    series = rng.normal(size=(T * PW.sampling_interval_from_t(sampling_t), 2)).astype(np.float32)
    t = np.arange(series.shape[0]) * 0.1
    got = PW.slbp_sensitivity_windows(series, t, windows, pred_len, sampling_t, step)
    want = JW.slbp_sensitivity_windows(series, t, windows, pred_len, sampling_t, step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if geometry[0] == 2000:
        assert len(got[0]) == 191 and len(got[1]) == 181
    if geometry[0] == 120:
        assert got[1].shape == (0, 30, 2)
    with pytest.raises(ValueError):
        PW.slbp_sensitivity_windows(series[None], t, windows, pred_len, sampling_t, step)


# -- summarizers, predicates, paths ----------------------------------------------

def _sampling_cache(rng, n=4, S=6):
    return [rng.normal(size=(12, 2, S)).astype(np.float32) for _ in range(n)]


def test_summarizers_and_predicates_match_jax():
    rng = np.random.default_rng(0)
    samp = _sampling_cache(rng)
    gx2 = [rng.random((12, 2)).astype(np.float32) for _ in range(4)]
    gx3 = [g[None] for g in gx2]
    targets = [rng.normal(size=(12, 2)).astype(np.float32) for _ in range(3)]
    scaler = mock.Mock(scaler="standard", scaler_transform=lambda d: (d - 0.5) / 2.0)
    for pd in (0, 1):
        for model in (None, scaler):
            assert (P.summarize_slbp_sensitivity(samp, targets, model=model, pred_dim=pd)
                    == J.summarize_slbp_sensitivity(samp, targets, model=model, pred_dim=pd))
        assert (P.summarize_slbp_sampling_for_fig6(samp, pd)
                == J.summarize_slbp_sampling_for_fig6(samp, pd))
        for g in (gx2, gx3):
            assert P.summarize_slbp_gx_for_fig6(g, pd) == J.summarize_slbp_gx_for_fig6(g, pd)
        for data in (samp, gx2, gx3):
            assert (P.summarize_slbp_mpv_cache_for_fig5(data, pd)
                    == J.summarize_slbp_mpv_cache_for_fig5(data, pd))
    # the intrinsic dimension on a low-rank ensemble, and its degenerate cases
    low = rng.normal(size=(40, 3)) @ rng.normal(size=(3, 24))
    for t in (low, low[:1], np.zeros((5, 4)), low[0]):
        a, b = P._slbp_intrinsic_dimension(t), J._slbp_intrinsic_dimension(t)
        assert a == b or (np.isnan(a) and np.isnan(b))
    for data in ([], samp, gx2, gx3, [samp[0], gx2[0]], [np.zeros((2, 12, 2))], [np.zeros(5)]):
        for ndim in (2, 3):
            assert (P._slbp_cache_elements_have_ndim(data, ndim)
                    == J._slbp_cache_elements_have_ndim(data, ndim))
        assert P._slbp_cache_elements_are_gx(data) == J._slbp_cache_elements_are_gx(data)


@pytest.mark.parametrize("call", [
    lambda M, samp, gx: M.summarize_slbp_sensitivity(gx, gx),
    lambda M, samp, gx: M.summarize_slbp_sensitivity(samp, [s[..., 0] for s in samp], pred_dim=2),
    lambda M, samp, gx: M.summarize_slbp_sampling_for_fig6(gx),
    lambda M, samp, gx: M.summarize_slbp_sampling_for_fig6(samp, pred_dim=5),
    lambda M, samp, gx: M.summarize_slbp_gx_for_fig6(samp),
    lambda M, samp, gx: M.summarize_slbp_gx_for_fig6(gx, pred_dim=2),
    lambda M, samp, gx: M.summarize_slbp_mpv_cache_for_fig5([np.zeros((2, 3, 4, 5))]),
    lambda M, samp, gx: M.summarize_slbp_mpv_cache_for_fig5([]),
])
def test_summarizers_raise_as_jax(call):
    rng = np.random.default_rng(1)
    samp = _sampling_cache(rng)
    gx = [s[..., 0] for s in samp]
    with pytest.raises(Exception) as want:
        call(J, samp, gx)
    with pytest.raises(want.type):
        call(P, samp, gx)


def test_cache_paths_match_jax(tmp_path):
    for root in (tmp_path, "ews_results/NsDiff_machine/NsDiff"):
        for step in (10, 20):
            assert (str(P.slbp_sensitivity_cache_path(root, NAME, "decrease", step))
                    == str(J.slbp_sensitivity_cache_path(root, NAME, "decrease", step)))
            for sub in (None, "", "SLPB_1000000.0"):
                assert (str(P.slbp_fig6_pred_future_gx_cache_path(root, NAME, "increase", step, sub))
                        == str(J.slbp_fig6_pred_future_gx_cache_path(root, NAME, "increase",
                                                                      step, sub)))
                for kind in ("pred_future", "gx", "sampling_pred_future"):
                    assert (str(P.slbp_fig6_cache_path(root, NAME, "increase", step, sub, kind))
                            == str(J.slbp_fig6_cache_path(root, NAME, "increase", step, sub,
                                                          kind)))
    # with no subdirectory the sampling analysis reads the sensitivity sweep's file
    assert (P.slbp_fig6_cache_path(tmp_path, NAME, "increase")
            == P.slbp_sensitivity_cache_path(tmp_path, NAME, "increase"))
    for name in (NAME, LEGACY, "dataset__a__b", 7):
        assert (P._legacy_single_underscore_model_name(name)
                == J._legacy_single_underscore_model_name(name))
    t = np.arange(2_000_000) * 0.1
    np.testing.assert_array_equal(P.torch_data_preprocessing_like_slbp(t, 100),
                                  J.torch_data_preprocessing_like_slbp(t, 100))


# -- the analyses on the tracked model --------------------------------------------

def test_gx_analysis_matches_jax(swept):
    got, want = swept["p_gx"], swept["j_gx"]
    assert len(got["gx_mpv"]) == len(want["gx_mpv"]) == N_WIN
    np.testing.assert_allclose(got["gx_mpv"], want["gx_mpv"], rtol=GX_TOL, atol=GX_TOL)
    for a, b in zip(got["gx_list"], want["gx_list"]):
        assert a.shape == b.shape == (100, 2)
        np.testing.assert_allclose(a, b, rtol=GX_TOL, atol=GX_TOL)
    np.testing.assert_array_equal(got["time_points"], want["time_points"])
    for k in ("windows", "pred_len", "sampling_t", "sample_window_step"):
        assert got[k] == want[k], k
    assert Path(got["cache_path"]).name == Path(want["cache_path"]).name == (
        f"{NAME}_pred_future_increase_10_gx.pt")


def test_sensitivity_matches_jax_on_jax_normals(swept):
    got, want = swept["p_sens"], swept["j_sens"]
    assert len(got["mpv"]) == len(want["mpv"]) == N_WIN
    assert (np.asarray(want["mpv"]) > 0).all()
    np.testing.assert_allclose(got["mpv"], want["mpv"], rtol=SAME_NORMALS_REL)
    np.testing.assert_allclose(got["prediction_error"], want["prediction_error"],
                               rtol=SAME_NORMALS_REL)
    np.testing.assert_array_equal(got["time_points"], want["time_points"])
    assert len(got["time_points"]) == 191
    for a in got["pred_future_list"]:
        assert a.shape == (100, 2, SMALL["n_z_samples"]) and a.dtype == np.float32
    for k in ("windows", "pred_len", "sampling_t", "sample_window_step", "model_name"):
        assert got[k] == want[k], k
    assert Path(got["cache_path"]).name == Path(want["cache_path"]).name


def test_caches_read_both_ways(swept, traj):
    """Each package on the other's caches returns the writer's MPV exactly,
    through the sensitivity sweep (a hit: the model only scales the
    targets) and the sampling analysis, which shares its file."""
    series, t = traj
    roots = swept["roots"]
    kw = dict(data_trend="increase", max_windows=N_WIN, infer_params=dict(SMALL))
    for reader, root, writer in ((P, roots["jax"], swept["j_sens"]),
                                 (J, roots["port"], swept["p_sens"])):
        extra = {"device": "cpu"} if reader is P else {}
        with mock.patch.object(reader, "batched_window_ensemble", side_effect=AssertionError):
            sens = reader.slbp_sensitivity_ews(root, NAME, series, t, **kw, **extra)
            samp = reader.slbp_sampling_analysis(root, NAME, series, t, allow_unavailable=False,
                                                 **extra)
        assert [float(v) for v in sens["mpv"]] == [float(v) for v in writer["mpv"]]
        assert ([float(v) for v in sens["prediction_error"]]
                == [float(v) for v in writer["prediction_error"]])
        assert samp["available"] and samp["mpv"] == [float(v) for v in writer["mpv"]]
        assert samp["cache_path"] == writer["cache_path"]
        assert len(samp["intrinsic_dimension"]) == N_WIN
    # the gx caches too, with no model built
    for reader, root, writer in ((P, roots["jax"], swept["j_gx"]),
                                 (J, roots["port"], swept["p_gx"])):
        with mock.patch.object(reader, "load_sensitivity_model", side_effect=AssertionError):
            got = reader.slbp_gx_analysis(root, NAME, series, t)
        assert got["gx_mpv"] == writer["gx_mpv"] and got["cache_path"] == writer["cache_path"]


def test_fresh_sweep_equals_its_cache_hit(tmp_path, traj):
    """The ensembles a sweep returns are C-ordered, as the cache it writes
    and as JAX's: numpy sums a strided array in another order, and at 64
    draws a window the MPV of the fresh list then differed from the MPV of
    the same list read back in the last bits."""
    series, t = traj
    root = _tree(tmp_path)
    fresh = P.slbp_sensitivity_ews(root, NAME, series, t, device="cpu", max_windows=2,
                                   infer_params={"n_z_samples": 64, "sampling_dtype": "float32"})
    assert all(a.flags["C_CONTIGUOUS"] for a in fresh["pred_future_list"])
    hit = P.slbp_sampling_analysis(root, NAME, series, t, device="cpu", allow_unavailable=False)
    assert hit["mpv"] == [float(v) for v in fresh["mpv"]]


@pytest.mark.parametrize("which", ["pred_future_gx", "gx", "pred_future", "legacy_name"])
def test_gx_fallback_chain_matches_jax(tmp_path, traj, which):
    """One cache under each of the four names: both packages read it (no
    model); with every name present the first wins; a sampling cache under
    an old gx name raises, under the two pred_future names it is passed over
    and gx is computed into the first name."""
    series, t = traj
    rng = np.random.default_rng(3)
    gx = [rng.random((100, 2)).astype(np.float32) for _ in range(N_WIN)]
    samp = [rng.normal(size=(100, 2, 4)).astype(np.float32) for _ in range(N_WIN)]

    def paths(M, root):
        return {"pred_future_gx": M.slbp_fig6_pred_future_gx_cache_path(root, NAME, "increase"),
                "gx": M.slbp_fig6_cache_path(root, NAME, "increase", kind="gx"),
                "pred_future": M.slbp_fig6_cache_path(root, NAME, "increase"),
                "legacy_name": M.slbp_fig6_cache_path(root, LEGACY, "increase")}

    results = {}
    for M in (J, P):
        root = _tree(tmp_path / M.__name__.split(".")[0])
        p = paths(M, root)
        save_tensor_list(gx, p[which])
        with mock.patch.object(M, "load_sensitivity_model", side_effect=AssertionError):
            results[M] = M.slbp_gx_analysis(root, NAME, series, t)
        assert results[M]["cache_path"] == str(p[which])
        assert results[M]["gx_mpv"] == J.summarize_slbp_gx_for_fig6(gx)
        # every name present: the first in the chain serves
        for other in p.values():
            if not other.exists():
                save_tensor_list([g * 2 for g in gx], other)
        with mock.patch.object(M, "load_sensitivity_model", side_effect=AssertionError):
            first = M.slbp_gx_analysis(root, NAME, series, t)
        assert first["cache_path"] == str(p["pred_future_gx"])
    assert results[J]["gx_mpv"] == results[P]["gx_mpv"]
    # a sampling cache under the name
    root = _tree(tmp_path / "samp")
    p = paths(P, root)
    save_tensor_list(samp, p[which])
    if which == "gx":
        with pytest.raises(ValueError):
            P.slbp_gx_analysis(root, NAME, series, t, device="cpu")
        jroot = _tree(tmp_path / "jsamp")
        save_tensor_list(samp, paths(J, jroot)["gx"])
        with pytest.raises(ValueError):
            J.slbp_gx_analysis(jroot, NAME, series, t)
    elif which != "pred_future_gx":
        got = P.slbp_gx_analysis(root, NAME, series, t, device="cpu", max_windows=N_WIN)
        assert got["cache_path"] == str(p["pred_future_gx"]) and len(got["gx_mpv"]) == N_WIN
        assert len(load_tensor_list(p[which])[0].shape) == 3  # left as it was


@pytest.mark.parametrize("kind", ["sampling", "gx"])
def test_mpv_analysis_cache_hit_infers_the_step(tmp_path, traj, kind):
    """A cache of 96 windows was written at step 20 (2,000 points, W 100):
    asked for step 10, both packages infer 20 and give the same MPV and time
    axis, with no model."""
    series, t = traj
    rng = np.random.default_rng(4)
    shape = (100, 2, 5) if kind == "sampling" else (100, 2)
    data = [rng.random(shape).astype(np.float32) for _ in range(96)]
    cache = tmp_path / "datas" / "D_1e-05_increase.pt"
    save_tensor_list(data, cache)
    out = {}
    for M in (J, P):
        with mock.patch.object(M, "load_sensitivity_model", side_effect=AssertionError):
            out[M] = M.slbp_mpv_analysis(tmp_path, "absent", series, t, cache,
                                         sample_window_step=10, windows=100, pred_len=100)
        assert out[M]["sample_window_step"] == 20
        assert out[M]["uncertainty_source"] == kind and len(out[M]["mpv"]) == 96
    assert out[P]["mpv"] == out[J]["mpv"]
    np.testing.assert_array_equal(out[P]["time_points"], out[J]["time_points"])
    for k in ("windows", "pred_len", "sampling_t", "cache_path"):
        assert out[P][k] == out[J][k], k


def test_mpv_analysis_writes_a_sampling_cache(tmp_path, traj):
    """A missing cache is swept (the port on the CPU), written, then read
    back by both packages as it was written."""
    series, t = traj
    root = _tree(tmp_path / "tree")
    cache = root / "datas" / "sub" / "D_1e-05_increase.pt"
    first = P.slbp_mpv_analysis(root, NAME, series, t, cache, max_windows=2,
                                infer_params=dict(SMALL), device="cpu")
    assert first["uncertainty_source"] == "sampling" and len(first["mpv"]) == 2
    assert load_tensor_list(cache)[0].shape == (100, 2, 4)
    for M in (P, J):
        again = M.slbp_mpv_analysis(root, NAME, series, t, cache)
        assert again["mpv"] == first["mpv"]


def test_direct_model_cache_analysis(tmp_path, traj, swept):
    series, t = traj
    missing = tmp_path / "none.pt"
    for M in (J, P):
        with pytest.raises(ValueError, match="cache_kind"):
            M.slbp_direct_model_cache_analysis(MODEL, series, t, missing)
    gx_cache = swept["j_gx"]["cache_path"]
    for M in (J, P):
        with pytest.raises(ValueError, match="prediction_error requires a sampling cache"):
            M.slbp_direct_model_cache_analysis(MODEL, series, t, gx_cache,
                                               compute_prediction_error=True)
    # a sampling cache with the prediction error: the sweep's own numbers
    samp_cache = swept["j_sens"]["cache_path"]
    got = P.slbp_direct_model_cache_analysis(MODEL, series, t, samp_cache,
                                             compute_prediction_error=True, device="cpu")
    want = J.slbp_direct_model_cache_analysis(MODEL, series, t, samp_cache,
                                              compute_prediction_error=True)
    assert got["mpv"] == want["mpv"] and got["uncertainty_source"] == "sampling"
    assert ([float(v) for v in got["prediction_error"]]
            == [float(v) for v in want["prediction_error"]])
    np.testing.assert_array_equal(got["time_points"], want["time_points"])
    # a missing gx cache is computed (the port on the CPU) and read back by JAX
    out = tmp_path / "SLPB_200000.0" / "gx_D_1e-05_increase.pt"
    gx = P.slbp_direct_model_cache_analysis(MODEL, series, t, out, cache_kind="gx",
                                            max_windows=N_WIN, device="cpu")
    np.testing.assert_allclose(gx["mpv"], swept["j_gx"]["gx_mpv"], rtol=GX_TOL, atol=GX_TOL)
    assert J.slbp_direct_model_cache_analysis(MODEL, series, t, out)["mpv"] == gx["mpv"]


def test_raw_window_variance_on_the_tracked_trajectory(traj):
    series, t = traj
    got = P.slbp_raw_window_variance(series, t, windows=100, sampling_t=100, device="cpu")
    want = J.slbp_raw_window_variance(series, t, windows=100, sampling_t=100)
    assert got["variance"].dtype == np.float32 and got["variance"].shape == (191,)
    np.testing.assert_allclose(got["variance"], want["variance"], rtol=0,
                               atol=var_tol(100, series[::1000, 0]))
    np.testing.assert_array_equal(got["time_points"], want["time_points"])
    for M, kw in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(IndexError):
            M.slbp_raw_window_variance(series, t, pred_dim=2, **kw)
        with pytest.raises(ValueError):
            M.slbp_raw_window_variance(series[:, :, None], t, **kw)


def test_gx_metrics_reproduce_the_demo_record(tmp_path, traj):
    """The demo's scan (examples/slbp_demo.py) on its gx arm, over all 191
    windows: both packages on the CPU give the transition time and the gx
    metrics of ``demo_artifacts/summary.json`` within 0.1% (the record was
    written on another device), the bar the card is held to at 1%."""
    from upgdm_tpu.figures.mpv_collapse import locate_transition, metric_row_from_mpv

    series, t = traj
    record = json.loads((REPO / "demo_artifacts/summary.json").read_text())
    tt = locate_transition(np.asarray(t, float)[::1000], np.asarray(series, float)[::1000, 0],
                           "SLBP", "increase")["transition_time"]
    assert tt == record["transition_time_state"]
    metrics = {}
    for M, kw in ((J, {}), (P, {"device": "cpu"})):
        out = tmp_path / M.__name__.split(".")[0]
        out.mkdir()
        r = M.uncertainty_ews(model_save_file=MODEL, data_file=DATA, dynamic_type="SLBP",
                              cache_path=out / "mpv_cache.pt", nsdiff_g_path=out / "mpv_cache_gx.pt",
                              sample_window_step=10, uncertainty_method="gx", chunk_windows=16,
                              **kw)
        assert len(r["ews"]) == 191
        metrics[M] = metric_row_from_mpv(r["time_points"], r["ews"], tt, slope_window_points=10)
        for k in ("baseline_mpv", "pre_transition_drop_percent", "global_drop_percent"):
            assert abs(metrics[M][k] / record["gx_mpv"][k] - 1) <= 1e-3, (M.__name__, k)
    assert metrics[P]["global_min_mpv_time"] == metrics[J]["global_min_mpv_time"]


def test_sampling_analysis_allow_unavailable(tmp_path, traj):
    """A `sampling_pred_future` cache of the wrong shape: with
    ``allow_unavailable`` (the default) both packages say unavailable with
    the reason, without it both raise."""
    series, t = traj
    out = {}
    for M in (J, P):
        root = _tree(tmp_path / M.__name__.split(".")[0])
        bad = M.slbp_fig6_cache_path(root, NAME, "increase", kind="sampling_pred_future")
        save_tensor_list([np.zeros((100, 2), np.float32)], bad)
        out[M] = M.slbp_sampling_analysis(root, NAME, series, t)
        assert not out[M]["available"] and out[M]["mpv"] == []
        assert "sampling cache exists" in out[M]["reason"]
        with pytest.raises(ValueError, match="sampling cache exists"):
            M.slbp_sampling_analysis(root, NAME, series, t, allow_unavailable=False)
    assert Path(out[P]["cache_path"]).name == Path(out[J]["cache_path"]).name
    np.testing.assert_array_equal(out[P]["time_points"], out[J]["time_points"])


def test_analyses_run_on_the_card_by_default(tmp_path, traj):
    """Without ``device`` the analyses that build a model ask for the card;
    with none present they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    series, t = traj
    root = _tree(tmp_path / "tree")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.slbp_gx_analysis(root, NAME, series, t, max_windows=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.slbp_raw_window_variance(series, t)
    res = P.slbp_sampling_analysis(root, NAME, series, t, max_windows=1)
    assert not res["available"] and "CUDA" in res["reason"]
