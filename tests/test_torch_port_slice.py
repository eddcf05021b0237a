"""The port's NsDiff sampling-MPV slice held against the JAX package (CPU).

(a) the tracked SIS checkpoint loads strictly into the port, the port's
    state_dict loads strictly back into the JAX model (in memory and through
    a saved file), and f(x), g(x) agree on windows of the tracked corpus;
(b) sample_fn, fed the exact normals JAX draws, matches JAX per sample;
(c) fast_mpv_sweep's on-device reduction matches JAX's on a fixed ensemble;
plus the import and device guards.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.eval import uncertainty as JU
from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
from upgdm_tpu.utils import io as jio
from upgdm_tpu_torch.eval import uncertainty as U
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.ops.windows import sample_time_series, sliding_windows
from upgdm_tpu_torch.utils import io as pio
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SIS_MODEL = REPO / "demo_fig1/ews_results/model_compare/NsDiff/SIS"
SIS_DATA = REPO / "demo_fig1/spdata_sde_SIS/barabasi_albert_12_0/SIS_dynamic_eta0.0001d0.5_increase.pt"

TINY = dict(
    dataset_nf=1, windows=40, pred_len=20, rolling_length=10, diffusion_steps=20,
    scaler_type=None, d_model=32, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
    p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=4, task_model="NsDiff",
    diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2, activation="gelu",
    sampling_dtype="float32",
)


def _sis_windows(n, step):
    data = U.load_dynamic_data(SIS_DATA, dynamic_type="SIS")
    series, time = sample_time_series(data["torch_time_series"], data["time_data"], 0.1)
    wins, _ = sliding_windows(series, time, 100, step)
    return wins[:n]


def test_sis_checkpoint_round_trip_and_f_g(tmp_path):
    port, net_param = U.load_model_from_dir(SIS_MODEL, device="cpu")
    _, ckpt = jio.load_checkpoint(SIS_MODEL / "model_trained")
    sd = port.state_dict()
    assert set(sd) == set(ckpt)
    for k in ckpt:
        np.testing.assert_array_equal(sd[k], ckpt[k], err_msg=k)

    jm = JNsDiff(net_param)
    jm.load_state_dict(sd, strict=True)
    pio.save_checkpoint(tmp_path, "model_trained", sd, net_param)
    _, from_file = jio.load_checkpoint(tmp_path / "model_trained")
    JNsDiff(net_param).load_state_dict(from_file, strict=True)

    step = pio.read_model_config(SIS_MODEL)["dataset"]["interval_step"]
    wins = _sis_windows(2, step)
    x = port.scaler_transform(wins.reshape(-1, 100, 1)).astype(np.float32)
    f_w = jax.jit(lambda p, b: jm._apply_f(p, b))(jm.params, jnp.asarray(x))
    g_w = jax.jit(lambda p, b: jm._apply_g(p, b))(jm.params, jnp.asarray(x))
    with torch.no_grad():
        f = port._apply_f(torch.from_numpy(x))
        g = port._apply_g(torch.from_numpy(x))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_w), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_w), atol=1e-4)


def test_sis_sweep_end_to_end():
    """load_model_from_dir -> load_dynamic_data -> sliding_windows ->
    fast_mpv_sweep on the tracked SIS fixture: finite, positive MPV."""
    port, _ = U.load_model_from_dir(SIS_MODEL, device="cpu",
                                    infer_params={"n_z_samples": 8})
    step = pio.read_model_config(SIS_MODEL)["dataset"]["interval_step"]
    mpv, mean = U.fast_mpv_sweep(port, _sis_windows(3, step), 100, chunk_windows=2,
                                 device="cpu")
    assert mpv.shape == mean.shape == (3,)
    assert np.isfinite(mpv).all() and (mpv > 0).all() and np.isfinite(mean).all()


def _jax_normals(key, S, T, shape):
    """The normals nsdiff_p_sample_loop draws for each of the S sample keys
    (nsdiff.py:312-318, ops/diffusion.py:152-177): z_T, then z_t, t=T-1..1."""
    def draws(k):
        k, k0 = jax.random.split(k)
        z_T = jax.random.normal(k0, shape, jnp.float32)
        ks = jax.random.split(k, T - 1)
        return z_T, jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float32))(ks)

    z_T, zs = jax.vmap(draws)(jax.random.split(key, S))
    zs = np.array(zs)
    return [np.array(z_T)] + [zs[:, i] for i in range(T - 1)]


@pytest.mark.parametrize("use_gx", [False, True])
def test_sample_fn_matches_jax_under_shared_noise(use_gx):
    """Per sample, rtol 1e-4 / atol 1e-5: float32 on both sides, sums in
    another order, carried through 20 reverse steps."""
    jm = JNsDiff(TINY)
    port = NsDiffModel(TINY, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    x = (np.random.default_rng(7).normal(size=(3, 40, 1)) * 0.05 + 1.0).astype(np.float32)
    key = jax.random.key(11)
    S, T = 4, TINY["diffusion_steps"]
    want = np.asarray(jax.jit(lambda p, b, k: jm.sample_fn(p, b, k, S, use_gx))(
        jm.params, jnp.asarray(x), key))
    noise = _jax_normals(key, S, T, (3, TINY["pred_len"], 1))
    got = port.sample_fn(torch.from_numpy(x), n_z_samples=S, use_gx_directly=use_gx,
                         noise=noise).numpy()
    assert got.shape == want.shape == (3, 20, 1, S)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_mpv_reduce_matches_jax_on_fixed_ensemble():
    """fast_mpv_sweep's reduction (inverse scaler, population variance over
    samples, mean per window) against JAX's: rtol 1e-6."""
    node, O, S, chunk, n = 3, 20, 6, 2, 5
    rng = np.random.default_rng(8)
    ensembles = [rng.normal(size=(chunk * node, O, 1, S)).astype(np.float32)
                 for _ in range(3)]
    windows = rng.normal(size=(n, node, 40, 1)).astype(np.float32)
    net = dict(TINY, scaler_type="StandardScaler")
    jm, port = JNsDiff(net), NsDiffModel(net, device="cpu")
    for m in (jm, port):
        m.scaler_fit(windows.reshape(-1, 1) * 2.0 + 0.3)
    it_j, it_p = iter(ensembles), iter(ensembles)
    jm.evaluation_step = lambda b, use_gx_directly=False: (jnp.asarray(next(it_j)), None)
    port.evaluation_step = lambda b, use_gx_directly=False: (torch.from_numpy(next(it_p)), None)
    want = JU.fast_mpv_sweep(jm, windows, O, chunk_windows=chunk)
    got = U.fast_mpv_sweep(port, windows, O, chunk_windows=chunk, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n,)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib, pkgutil, upgdm_tpu_torch\n"
        "for m in pkgutil.walk_packages(upgdm_tpu_torch.__path__, 'upgdm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'networkx', 'pandas', 'upgdm_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NsDiffModel(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        U.load_model_from_dir(SIS_MODEL)
    port = NsDiffModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        U.fast_mpv_sweep(port, np.zeros((1, 1, 40, 1), np.float32), 20)


def test_summarizers_match_jax():
    rng = np.random.default_rng(9)
    ens = [rng.normal(size=(3, 20, 1, 5)).astype(np.float32) for _ in range(4)]
    gxs = [rng.uniform(0.1, 1, size=(3, 20, 1)).astype(np.float32) for _ in range(4)]
    port = NsDiffModel(dict(TINY, scaler_type="StandardScaler"), device="cpu")
    port.load_state_dict(dict(port.state_dict(), scaler_mean=np.float32([0.4]),
                              scaler_std=np.float32([1.7])))
    for got, want in ((U.summarize_pred_future_list(ens, port),
                       JU.summarize_pred_future_list(ens, port)),
                      (U.summarize_nsdiff_g_list(gxs), JU.summarize_nsdiff_g_list(gxs))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_batched_gx_matches_jax_on_sis():
    """g(x) over SIS windows through both packages' batched_gx (atol 1e-4)."""
    port, net_param = U.load_model_from_dir(SIS_MODEL, device="cpu")
    jm = JNsDiff(net_param)
    jm.load_state_dict(port.state_dict())
    step = pio.read_model_config(SIS_MODEL)["dataset"]["interval_step"]
    wins = _sis_windows(5, step)
    got = U.batched_gx(port, wins, chunk_windows=2, device="cpu")
    want = JU.batched_gx(jm, wins, chunk_windows=2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == (12, 100, 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


def test_ensemble_sweep_and_fast_sweep_agree():
    """The ensemble path summarised on the host equals the on-device MPV
    reduce when both draw from the same generator state (rtol 1e-5)."""
    net = dict(TINY, scaler_type="StandardScaler")
    wins = (np.random.default_rng(10).normal(size=(3, 2, 40, 1)) * 0.1 + 1).astype(np.float32)
    a, b = NsDiffModel(net, seed=4, device="cpu"), NsDiffModel(net, seed=4, device="cpu")
    for m in (a, b):
        m.scaler_fit(wins.reshape(-1, 1))
    ens = U.batched_window_ensemble(a, wins, 20, chunk_windows=2, device="cpu")
    assert len(ens) == 3 and ens[0].shape == (2, 20, 1, TINY["n_z_samples"])
    _, mpv_host = U.summarize_pred_future_list(ens, a)
    mpv_dev, _ = U.fast_mpv_sweep(b, wins, 20, chunk_windows=2, device="cpu")
    np.testing.assert_allclose(mpv_dev, np.asarray(mpv_host), rtol=1e-5)
