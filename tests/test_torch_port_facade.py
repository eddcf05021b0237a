"""The port's ``uncertainty_ews`` facade against the JAX package's, on the
trained ``demo_fig1`` SIS NsDiff model and its trajectory (CPU).

Sampling noise. Two JAX runs of the facade with different seeds differ
window by window by up to 0.59% of the MPV at n_z = 400 and 0.36% at 1,600
(float32 sampling, first three windows; measured on this fixture), and
JAX alone takes minutes of CPU there. A comparison of two independent
streams at the 1% bar would be mostly noise. So the MPV comparison hands the
port the normals JAX draws (the same keys, through the chain's ``noise``
seam) at a small n_z set through ``infer_params``: what is left is the
port's arithmetic against JAX's, float32 on both sides, window by window.
The other tests check the facade's control flow: the caches and sidecars
each package writes and the other reads, the raw-space rule on a cache hit,
the stale-sidecar step fallback, the MPV-level resume, the gx arm and the
window helpers.
"""
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from upgdm_tpu.eval import uncertainty as J
from upgdm_tpu.ops import windows as JW
from upgdm_tpu_torch.eval import uncertainty as P
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.ops import windows as PW

REPO = Path(__file__).resolve().parents[1]
MODEL = REPO / "demo_fig1/ews_results/model_compare/NsDiff/SIS"
DATA = REPO / "demo_fig1/spdata_sde_SIS/barabasi_albert_12_0/SIS_dynamic_eta0.0001d0.5_increase.pt"
N_Z = 16
FLOAT32 = {"n_z_samples": N_Z, "sampling_dtype": "float32"}
# the JAX package's bar for two sampled chains (tests/test_torch_parity.py)
MPV_REL = 0.01
SAME_NORMALS_REL = 1e-4


def _call(pkg, tmp, **kw):
    kw.setdefault("max_windows", 2)
    kw.setdefault("infer_params", dict(FLOAT32))
    if pkg is P:
        kw.setdefault("device", "cpu")
    Path(tmp).mkdir(parents=True, exist_ok=True)
    return pkg.uncertainty_ews(model_save_file=MODEL, data_file=DATA, dynamic_type="SIS",
                               cache_path=tmp, **kw)


def _jax_normals(key, S, shape, T):
    """The normals ``nsdiff_p_sample_loop`` draws for the S samples of
    ``sample_fn``'s key: T arrays [S, *shape], z_T first."""

    def one(k):
        k, k0 = jax.random.split(k)
        z0 = jax.random.normal(k0, shape, jnp.float32)
        zs = jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float32))(
            jax.random.split(k, T - 1))
        return jnp.concatenate([z0[None], zs])

    z = np.asarray(jax.vmap(one)(jax.random.split(key, S)))  # [S, T, *shape]
    return [z[:, i] for i in range(T)]


def _port_on_jax_normals():
    """Patch the port's chain to take, chunk after chunk, the normals of the
    keys JAX's facade uses: seed 0, ``next_key`` counter 1 taken by the
    model's init, then one key a chunk."""
    orig = NsDiffModel.sample_chain
    counter = [1]

    def sample_chain(self, y0_hat, gx, generator=None, n_z_samples=None,
                     use_gx_directly=False, noise=None, use_kernel=None):
        counter[0] += 1
        key = jax.random.fold_in(jax.random.key(0), counter[0])
        S = n_z_samples or self.n_z_samples
        noise = _jax_normals(key, S, tuple(y0_hat.shape), self.diffusion_steps)
        return orig(self, y0_hat, gx, generator, n_z_samples, use_gx_directly, noise, use_kernel)

    return mock.patch.object(NsDiffModel, "sample_chain", sample_chain)


def test_cache_mode_none_matches_jax_window_by_window(tmp_path):
    """Two windows of the SIS trajectory, n_z 16, float32: MPV within 1% of
    JAX's window by window, and on the same normals within SAME_NORMALS_REL
    (float32 on both sides with sums in another order, the bar of a sampled
    chain against its plain chain; measured 7e-7); the facade's dict has
    JAX's keys and values."""
    want = _call(J, tmp_path / "j", cache_mode="none", chunk_windows=1)
    with _port_on_jax_normals():
        got = _call(P, tmp_path / "p", cache_mode="none", chunk_windows=1)
    assert set(got) == set(want)
    w, g = np.asarray(want["ews"]), np.asarray(got["ews"])
    assert w.shape == g.shape == (2,) and (w > 0).all()
    np.testing.assert_allclose(g, w, rtol=MPV_REL)
    np.testing.assert_allclose(g, w, rtol=SAME_NORMALS_REL)
    np.testing.assert_allclose(got["pred_mean"], want["pred_mean"], rtol=1e-4)
    np.testing.assert_allclose(got["time_points"], want["time_points"])
    for k in ("sample_window_step", "sampling_t", "windows", "pred_len", "task_model",
              "uncertainty_method", "uncertainty_source", "dynamic_type"):
        assert got[k] == want[k], k
    assert got["pred_future_list"] is None
    # the gx side artifact (save_nsdiff_g) is deterministic: float32 on both
    np.testing.assert_allclose(got["nsdiff_g"]["ews"], want["nsdiff_g"]["ews"], rtol=1e-5)


def test_caches_and_sidecars_read_both_ways(tmp_path):
    """The port's `.pt` and `.mpv.json` serve JAX's facade and JAX's serve
    the port's, with no model built on the reading side; the MPV read back
    is the writer's own, in raw space."""
    n_z = dict(FLOAT32, n_z_samples=4)
    for writer, reader in ((P, J), (J, P)):
        out = tmp_path / writer.__name__.split(".")[0]
        first = _call(writer, out, infer_params=n_z)
        pt = Path(first["cache_path"])
        assert pt.exists() and pt.with_name(pt.name + ".mpv.json").exists()
        side = json.loads(pt.with_name(pt.name + ".mpv.json").read_text())
        assert side["complete"] and side["raw_space"] and side["n_windows_done"] == 2
        with mock.patch.object(reader, "load_model_from_dir", side_effect=AssertionError):
            again = _call(reader, out, infer_params=n_z, save_nsdiff_g=False)
        assert len(again["pred_future_list"]) == 2
        np.testing.assert_allclose(again["ews"], first["ews"], rtol=1e-6)
        np.testing.assert_allclose(again["pred_mean"], first["pred_mean"], rtol=1e-6)


def test_cache_hit_is_raw_space_through_the_scaler_view(tmp_path):
    """A `.pt` hit inverts the scaler with the checkpoint's statistics alone
    (no model, no device tensor): the MPV of the fresh sweep, not the
    scaled-space one (which differs by scaler_std^2)."""
    fresh = _call(P, tmp_path, infer_params=dict(FLOAT32, n_z_samples=4), save_nsdiff_g=False)
    view = P.load_scaler_view(MODEL)
    assert view is not None and view.scaler_std.dtype == np.float32
    with mock.patch.object(P, "load_model_from_dir", side_effect=AssertionError):
        hit = _call(P, tmp_path, save_nsdiff_g=False)
    np.testing.assert_allclose(hit["ews"], fresh["ews"], rtol=1e-6)
    _, scaled = P.summarize_pred_future_list(hit["pred_future_list"])
    np.testing.assert_allclose(hit["ews"], np.asarray(scaled) * float(view.scaler_std[0]) ** 2,
                               rtol=1e-5)
    assert P.load_scaler_view(tmp_path) is None


def test_sidecars_alone_resume_and_fall_back(tmp_path):
    """Without the `.pt`: a complete sidecar serves the MPV without a model;
    a partial one (no `.partial` left) resumes at the MPV level from its
    done windows; a stale one whose step no longer fits gives way to the
    default step."""
    n_z = dict(FLOAT32, n_z_samples=4)
    full = _call(P, tmp_path, infer_params=n_z, save_nsdiff_g=False)
    pt = Path(full["cache_path"])
    side_path = pt.with_name(pt.name + ".mpv.json")
    pt.unlink()
    with mock.patch.object(P, "load_model_from_dir", side_effect=AssertionError):
        served = _call(P, tmp_path, infer_params=n_z, save_nsdiff_g=False)
    assert served["pred_future_list"] is None and served["ews"] == full["ews"]
    # half done: the first window's MPV comes from the sidecar, the second is swept
    side = json.loads(side_path.read_text())
    side.update(n_windows_done=1, complete=False, ews=side["ews"][:1],
                pred_mean=side["pred_mean"][:1])
    side_path.write_text(json.dumps(side))
    resumed = _call(P, tmp_path, infer_params=n_z, save_nsdiff_g=False)
    assert resumed["pred_future_list"] is None and len(resumed["ews"]) == 2
    assert resumed["ews"][0] == full["ews"][0] and resumed["ews"][1] > 0
    assert not pt.exists() and json.loads(side_path.read_text())["complete"]
    # stale: another step and another fingerprint -> the default step (SIS: 50)
    side = json.loads(side_path.read_text())
    side.update(sample_window_step=7, fingerprint="stale")
    side_path.write_text(json.dumps(side))
    fell_back = _call(P, tmp_path, infer_params=n_z, save_nsdiff_g=False, cache_mode="none")
    assert fell_back["sample_window_step"] == PW.DEFAULT_SAMPLE_WINDOW_STEP["SIS"] == 50


def test_gx_arm_matches_jax_and_serves_from_its_cache(tmp_path):
    want = _call(J, tmp_path / "j", uncertainty_method="nsdiff_g")
    got = _call(P, tmp_path / "p", uncertainty_method="preg")
    assert got["uncertainty_method"] == "gx" and got["uncertainty_source"] == "gx"
    np.testing.assert_allclose(got["ews"], want["ews"], rtol=1e-5)
    assert Path(got["cache_path"]).name.endswith("_gx.pt")
    side = json.loads(Path(got["cache_path"] + ".mpv.json").read_text())
    assert side["pred_dim"] == 0 and side["complete"]
    with mock.patch.object(P, "load_model_from_dir", side_effect=AssertionError):
        again = _call(P, tmp_path / "p", uncertainty_method="g")
    assert again["ews"] == got["ews"] and len(again["nsdiff_g"]["pred_future_list"]) == 2


def test_facade_arguments_and_refusals(tmp_path):
    with pytest.raises(ValueError, match="uncertainty_method"):
        _call(P, tmp_path, uncertainty_method="mpv")
    with pytest.raises(ValueError, match="cache_mode"):
        _call(P, tmp_path, cache_mode="read")
    with pytest.raises(ValueError, match="data_file or torch_time_series"):
        P.uncertainty_ews(model_save_file=MODEL, device="cpu")
    with pytest.raises(NotImplementedError, match="graph families"):
        _call(P, tmp_path, task_model="DiffSTG")
    assert not any(tmp_path.iterdir())  # nothing written on the way


def test_load_sensitivity_model_reads_the_models_layout(tmp_path):
    """``models/<name>`` + ``models/<name>.yaml``: the port builds the
    checkpoint's model on the CPU with the JAX package's weights and config,
    with ``infer_params`` applied; a missing file raises."""
    import shutil

    models = tmp_path / "study" / "models"
    models.mkdir(parents=True)
    shutil.copy(MODEL / "model_trained", models / "sis")
    shutil.copy(MODEL / "model_trained.yaml", models / "sis.yaml")
    model, cfg, net = P.load_sensitivity_model(tmp_path / "study", "sis", device="cpu",
                                               infer_params={"n_z_samples": 7})
    jmodel, jcfg, jnet = J.load_sensitivity_model(tmp_path / "study", "sis",
                                                  infer_params={"n_z_samples": 7})
    assert cfg == jcfg == P.read_model_config(MODEL) and net["n_z_samples"] == 7
    assert model.n_z_samples == jmodel.n_z_samples == 7
    want = jmodel.state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    with pytest.raises(FileNotFoundError):
        P.load_sensitivity_model(tmp_path / "study", "other", device="cpu")


def test_paths_and_window_helpers_match_jax():
    assert P.PROJECT_ROOT == J.PROJECT_ROOT
    assert PW.DEFAULT_SAMPLE_WINDOW_STEP == JW.DEFAULT_SAMPLE_WINDOW_STEP
    assert PW.DEFAULT_SAMPLING_T == JW.DEFAULT_SAMPLING_T
    for cache, data, dyn in ((None, None, "SIS"), (MODEL, DATA, "SIS"), ("ews/x.pt", DATA, None),
                             ("ews", None, "neuronal"), ("ews", DATA, "SLBP")):
        for model in (None, MODEL):
            for suffix in ("", "_gx"):
                assert (P.resolve_cache_path(cache, model, data, dyn, suffix)
                        == J.resolve_cache_path(cache, model, data, dyn, suffix))
            assert P.default_cache_dir(model, dyn) == J.default_cache_dir(model, dyn)
        assert P.data_cache_name(data, "_gx") == J.data_cache_name(data, "_gx")
    assert P.resolve_figure_path("a/b.pt") == J.resolve_figure_path("a/b.pt")
    for dyn in ("SIS", "neuronal", "biomass", "SLBP", "other"):
        for task in ("NsDiff", "DiffSTG"):
            cfg = {"interval_step": 3}
            assert (P.default_sample_window_step(dyn, task, cfg)
                    == J.default_sample_window_step(dyn, task, cfg))
    rng = np.random.default_rng(0)
    series = rng.normal(size=(3, 57, 2)).astype(np.float32)
    t = np.arange(57) * 0.1
    for windows, step in ((10, 1), (10, 7), (57, 3), (20, 50)):
        got, gt = PW.build_sliding_windows_compat(series, t, windows, step)
        want, wt = JW.build_sliding_windows_compat(series, t, windows, step)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
        np.testing.assert_array_equal(gt, wt)
    for length in (5, 10, 57, 400):
        for windows in (10, 100):
            for step in (1, 2, 5, 50):
                assert (PW.sliding_window_count(length, windows, step)
                        == JW.sliding_window_count(length, windows, step))
                for cache_len in (0, 1, 2, 3, 7, 48, 301):
                    assert (PW.infer_sample_window_step_from_cache(length, windows, cache_len, step)
                            == JW.infer_sample_window_step_from_cache(length, windows,
                                                                      cache_len, step))
