"""The port's real-data pipeline (``eval/real_data.py``,
``figures/real_systems.py``) against a fresh run of the JAX package's (CPU).

Both packages' CLIs run on the tracked ``demo_real`` record and model with
the call of ``examples/real_data_demo.py`` (g(x) of the trained NsDiff model
over 402 windows, AR(1), variance). The signal CSVs have the same header
and rows in the same order; the trajectory, AR(1) and variance rows are
equal (the variance is pandas' online update restated), the model rows
within g(x)'s bar, atol and rtol 1e-4. Each package reads the
other's ``model_uncertainty.pt``. The same run with ``bury_ml`` reads a Bury
CSV that the port wrote. The committed CSV under ``demo_real/figures`` is not
a reference: its model rows predate the current g(x) sweep.
"""
import csv
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from upgdm_tpu.eval import real_data as JR
from upgdm_tpu_torch.eval import bury as PB
from upgdm_tpu_torch.eval import real_data as PR
from upgdm_tpu_torch.figures import real_systems as PRS
from upgdm_tpu_torch.utils import io as pio
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "demo_real"
NAME = "slbp_empirical_demo"
SIGNALS = ["model_uncertainty", "model_trend", "ar1", "variance"]
GX_TOL = 1e-4  # g(x): atol and rtol (tests/test_torch_parity.py:107)


def _argv(root, *signals, device=True, figures="figures"):
    argv = ["--data-root", str(DEMO / "data"), "--data-real-names", NAME,
            "--model-dir", str(DEMO / "model"),
            "--real-data-result-root", str(root / "results"),
            "--bury-prob-root", str(root / "bury"), "--output-root", str(root / figures),
            "--signals", *(signals or SIGNALS)]
    return argv + (["--device", "cpu"] if device else [])


def _signals_csv(root, figures="figures"):
    return root / figures / NAME / f"{NAME}_real_data_ews_signals.csv"


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _num(field):
    return float(field) if field != "" else np.nan


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on demo_real: {"jax": root, "port": root}."""
    pytest.importorskip("matplotlib")
    out = {}
    for name, main, device in (("jax", JR.main, False), ("port", PR.main, True)):
        root = tmp_path_factory.mktemp(name)
        main(_argv(root, device=device))
        out[name] = root
    return out


def assert_signal_rows_match(got_rows, want_rows):
    assert got_rows[0] == want_rows[0] == PR.SIGNAL_COLUMNS
    assert len(got_rows) == len(want_rows)
    by_signal = {}
    for g, w in zip(got_rows[1:], want_rows[1:]):
        assert g[:3] == w[:3]
        assert g[3] == w[3] or _num(g[3]) == _num(w[3]), (g, w)
        by_signal.setdefault(g[1], ([], []))
        by_signal[g[1]][0].append(_num(g[4]))
        by_signal[g[1]][1].append(_num(w[4]))
    for signal, (g, w) in by_signal.items():
        g, w = np.asarray(g), np.asarray(w)
        if signal in ("trajectory", "ar1", "variance"):
            np.testing.assert_array_equal(g, w, err_msg=signal)
        elif signal in ("model_uncertainty", "model_trend"):
            np.testing.assert_allclose(g, w, rtol=GX_TOL, atol=GX_TOL, err_msg=signal)
        else:  # the Bury columns, read from the same CSV
            np.testing.assert_array_equal(g, w, err_msg=signal)
    return {k: len(v[0]) for k, v in by_signal.items()}


def test_cli_reproduces_a_fresh_jax_run(runs):
    counts = assert_signal_rows_match(_rows(_signals_csv(runs["port"])),
                                      _rows(_signals_csv(runs["jax"])))
    assert counts == {"trajectory": 501, "model_uncertainty": 402, "model_trend": 363,
                      "ar1": 501, "variance": 501}
    for root in runs.values():
        for suffix in (".png", ".svg"):
            assert (root / "figures" / NAME / f"{NAME}_real_data_ews{suffix}").stat().st_size


def test_model_caches_load_on_the_other_side(runs):
    caches = {k: PR.model_cache_path(NAME, v / "results") for k, v in runs.items()}
    want = JR.parse_model_uncertainty_cache(caches["jax"], 0)
    for reader in (PR.parse_model_uncertainty_cache, JR.parse_model_uncertainty_cache):
        for side in ("jax", "port"):
            t, v = reader(caches[side], 0)
            assert t is None and len(v) == 402
            np.testing.assert_allclose(v, want[1], rtol=GX_TOL, atol=GX_TOL)
    jl, pl = JR.uio.load_pt(caches["jax"]), pio.load_pt(caches["port"])
    assert isinstance(pl, list) and len(pl) == len(jl) == 402
    assert all(p.dtype == j.dtype and p.shape == j.shape == (2, 100) for p, j in zip(pl, jl))


def test_cache_hit_runs_no_model(runs, monkeypatch, tmp_path):
    """A second run over the port's results is a cache hit: no model is
    loaded; JAX's run over the port's cache writes the same rows."""
    root = tmp_path / "again"
    shutil.copytree(runs["port"] / "results", root / "results")

    def no_model(*a, **k):
        raise AssertionError("the cache should have been hit")

    monkeypatch.setattr(PR, "load_model_from_dir", no_model)
    PR.main(_argv(root))
    JR.main(_argv(root, device=False, figures="jax_figures"))
    got = _rows(_signals_csv(root))
    assert got == _rows(_signals_csv(runs["port"]))
    assert_signal_rows_match(got, _rows(_signals_csv(root, "jax_figures")))


def test_bury_signal_over_a_port_bury_csv(runs, tmp_path):
    """The port's Bury CLI writes the record's probabilities; both packages'
    real-data CLIs read them (and the cached g(x)) into the same rows."""
    root = tmp_path / "bury_run"
    shutil.copytree(runs["port"] / "results", root / "results")
    PB.main(["--data-root", str(DEMO / "data"), "--output-root", str(root / "bury"),
             "--data-real-names", NAME, "--max-models", "2", "--device", "cpu"])
    signals = SIGNALS + ["bury_ml"]
    PR.main(_argv(root, *signals))
    got = _rows(_signals_csv(root))
    jroot = tmp_path / "jax_bury"
    shutil.copytree(root / "results", jroot / "results")
    shutil.copytree(root / "bury", jroot / "bury")
    JR.main(_argv(jroot, *signals, device=False))
    counts = assert_signal_rows_match(got, _rows(_signals_csv(jroot)))
    assert counts["bury_ml"] == 4 * 44
    table, path = PR.load_bury_ml_probabilities(NAME, root / "bury")
    jtable, jpath = JR.load_bury_ml_probabilities(NAME, root / "bury")
    assert path == jpath and list(table) == list(jtable.columns)
    for c in table:
        np.testing.assert_array_equal(table[c], jtable[c].to_numpy())


def test_bury_csv_errors_are_jax(tmp_path):
    for mod in (PR, JR):
        with pytest.raises(FileNotFoundError, match="no Bury ML probability CSV"):
            mod.load_bury_ml_probabilities("x", tmp_path)
    (tmp_path / "x_bury_ml_probs.csv").write_text("time,fold_prob\n1.0,0.5\n")
    for mod in (PR, JR):
        with pytest.raises(ValueError, match=r"lacks required columns \['hopf_prob'"):
            mod.load_bury_ml_probabilities("x", tmp_path)


def test_cache_layouts_are_jax(tmp_path):
    rng = np.random.default_rng(0)
    gx = [rng.uniform(size=(2, 5)).astype(np.float32) for _ in range(4)]
    layouts = {
        "list": gx,
        "nested": {"data_save_list": gx},
        "summary": {"time": np.arange(4.0), "model_uncertainty": rng.uniform(size=4)},
        "values": {"time": np.arange(4.0), "values": rng.uniform(size=4)},
    }
    for name, obj in layouts.items():
        pio.save_pt(obj, tmp_path / f"{name}.pt")
        for pred_dim in (0, 1):
            t, v = PR.parse_model_uncertainty_cache(tmp_path / f"{name}.pt", pred_dim)
            jt, jv = JR.parse_model_uncertainty_cache(tmp_path / f"{name}.pt", pred_dim)
            assert (t is None) == (jt is None)
            if t is not None:
                np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(v, jv)
    for bad, err in (({"x": 1}, "unrecognized"), ("text", "not a tensor list")):
        pio.save_pt(bad, tmp_path / "bad.pt")
        for mod in (PR, JR):
            with pytest.raises(ValueError, match=err):
                mod.parse_model_uncertainty_cache(tmp_path / "bad.pt", 0)
    with pytest.raises(ValueError, match="out of range"):
        PR.parse_model_uncertainty_cache(tmp_path / "list.pt", 2)


def test_record_helpers_are_jax():
    rng = np.random.default_rng(1)
    for n, need, interval in ((50, 200, 1), (37, 100, 10), (300, 100, 2), (2, 5, 1)):
        ts = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
        ts[n // 3] = ts[n // 3 - 1]  # a duplicate stamp
        rec = {"ys_dynamic": rng.normal(size=(n, 2)).astype(np.float32), "ts_dynamic": ts,
               "transition_index": n // 2, "tp_values": np.ones(n, np.float32)}
        got, a = PR.ensure_min_time_points_linear_interp(dict(rec), need, interval)
        want, b = JR.ensure_min_time_points_linear_interp(dict(rec), need, interval)
        assert a == b and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for rec in ({"ts_dynamic": np.arange(10.0), "transition_index": 99},
                {"ts_dynamic": np.arange(10.0), "transition_time": 4.5},
                {"ts_dynamic": np.arange(10.0), "transition_age": 6.6},
                {"ts_dynamic": np.arange(10.0)}, {}):
        assert PR.get_transition_time_from_record(rec) == JR.get_transition_time_from_record(rec)
    t = np.arange(500) * 0.1
    for kw in (dict(num_values=5, sample_window_step=10, sampling_t=0.1, model_window=20),
               dict(num_values=10, sample_window_step=3, sampling_t=1.0),
               dict(num_values=401, sample_window_step=1, sampling_t=0.1)):
        np.testing.assert_array_equal(PR.infer_model_times(t, **kw), JR.infer_model_times(t, **kw))
    with pytest.raises(ValueError, match="window inference failed"):
        PR.infer_model_times(t, num_values=600)
    ys = rng.normal(size=(80, 2)).astype(np.float32)
    for mode in ("raw", "detrended"):
        np.testing.assert_array_equal(
            PR.prepare_model_input_series(ys, mode, "Lowess", 0.2, 0.2),
            JR.prepare_model_input_series(ys, mode, "Lowess", 0.2, 0.2))


def test_rolling_variance_is_pandas_bit_for_bit():
    """The classic variance rows rest on ``rolling_variance``: pandas'
    ``rolling(w).var()`` bit for bit over offsets, rounded values, NaN,
    constant runs (where pandas' online update leaves a residue that the
    port must leave too) and cancellation."""
    pd = pytest.importorskip("pandas")
    from upgdm_tpu_torch.eval.ews_classic import _window_size, rolling_variance

    rng = np.random.default_rng(11)
    for trial in range(240):
        n = int(rng.integers(2, 400))
        rw = float(rng.uniform(0.05, 1.0)) if trial % 2 else float(rng.integers(2, 40))
        x = rng.normal(size=n) * 10 ** rng.uniform(-6, 4)
        kind = trial % 6
        if kind == 1:
            x += rng.uniform(-1e6, 1e6)
        elif kind == 2:
            x = np.round(x, 1)
        elif kind == 3:
            x[rng.integers(0, n, max(1, n // 20))] = np.nan
        elif kind == 4:
            a = int(rng.integers(0, n))
            x[a : a + int(rng.integers(1, n))] = x[a]
        elif kind == 5:
            x = np.cumsum(x)
        want = pd.Series(x).rolling(_window_size(n, rw)).var().to_numpy()
        np.testing.assert_array_equal(rolling_variance(x, rw), want, err_msg=str(trial))


def test_default_args_and_signals_are_jax():
    got, want = vars(PR.default_args()), vars(JR.default_args())
    assert got.pop("device") is None and got == want
    assert PR.VALID_SIGNALS == JR.VALID_SIGNALS
    with pytest.raises(ValueError, match="Unknown signals"):
        PR.main(["--signals", "nope"])


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.main(_argv(tmp_path, device=False))
    assert not PR.model_cache_path(NAME, tmp_path / "results").exists()


def test_real_systems_composes(runs, tmp_path):
    """The composite figure over the port's cached g(x) (a cache hit)."""
    results = tmp_path / "results"
    shutil.copytree(runs["port"] / "results", results)
    out = PRS.main(["--data-real-names", NAME, "--output-dir", str(tmp_path / "fig"),
                    "--data-root", str(DEMO / "data"), "--real-data-result-root", str(results),
                    "--bury-prob-root", str(tmp_path / "bury"), "--model-dir",
                    str(DEMO / "model"), "--signals", *SIGNALS, "--device", "cpu"])
    assert out == tmp_path / "fig" / "real_systems_figure.png" and out.stat().st_size > 0
    assert (tmp_path / "fig/real_data_subfigs" / NAME / f"{NAME}_real_data_ews.png").exists()
