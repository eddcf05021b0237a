"""The port's cache-first evaluation runner held against the JAX package (CPU).

Both packages are driven with the same stub ``evaluation_step`` (a fixed
function of the scaled batch), so the ``.pt`` caches, the ``.partial`` /
``.meta`` checkpoints and the ``.mpv.json`` sidecars can be compared value
for value, and each side resumes a sweep the other began.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from upgdm_tpu.eval import uncertainty as JU
from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
from upgdm_tpu.models.tmdm import TMDMModel as JTMDM
from upgdm_tpu.utils import io as jio
from upgdm_tpu_torch.eval import uncertainty as U
from upgdm_tpu_torch.models.nsdiff import NsDiffModel
from upgdm_tpu_torch.models.tmdm import TMDMModel
from upgdm_tpu_torch.utils import io as pio
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NODE, W, P, S = 3, 24, 12, 5
TMDM = dict(
    dataset_nf=1, windows=W, pred_len=P, diffusion_steps=6, scaler_type="StandardScaler",
    d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=32, p_hidden_dims=[8, 8],
    p_hidden_layers=2, n_z_samples=S, task_model="TMDM", sampling_dtype="float32",
)
NSDIFF = dict(
    dataset_nf=1, windows=W, pred_len=P, rolling_length=8, diffusion_steps=6,
    scaler_type="StandardScaler", d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16,
    p_hidden_dims=[8, 8], p_hidden_layers=2, n_z_samples=S, task_model="NsDiff",
    sampling_dtype="float32",
)


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, NODE, W, 1)) * 0.2 + 1.0).astype(np.float32)


def _stub_ensemble(flat):
    """[B, W, 1] -> [B, P, 1, S]: a fixed function of the batch."""
    flat = np.asarray(flat, np.float32)
    level = flat.mean(axis=1)[:, None, :, None]                      # [B, 1, 1, 1]
    ramp = np.linspace(0.0, 1.0, P, dtype=np.float32)[None, :, None, None]
    spread = np.arange(1, S + 1, dtype=np.float32)[None, None, None, :]
    return level * spread + ramp * flat[:, -1:, :, None]


def _stubbed_pair():
    """A JAX and a port TMDM with one scaler and the stub evaluation_step;
    each records the batch sizes it was asked for."""
    jm, port = JTMDM(TMDM), TMDMModel(TMDM, device="cpu")
    for m in (jm, port):
        m.scaler_fit(_windows(4, seed=9).reshape(-1, 1) * 1.5 + 0.2)
        m.calls = []
    jm.evaluation_step = lambda b: (jm.calls.append(len(b)),
                                    (jnp.asarray(_stub_ensemble(b)), None))[1]
    port.evaluation_step = lambda b: (port.calls.append(len(b)),
                                      (torch.from_numpy(_stub_ensemble(b)), None))[1]
    return jm, port


def _sidecar(cache):
    return json.loads((cache.parent / (cache.name + ".mpv.json")).read_text())


def test_run_evaluation_cache_matches_jax(tmp_path):
    """Same list, same sidecar (equal keys in the same order, values at rtol
    1e-6), partials cleared, and the cache read back without a sweep."""
    jm, port = _stubbed_pair()
    wins = _windows(7)
    cj, cp = tmp_path / "jax" / "pred.pt", tmp_path / "port" / "pred.pt"
    want = JU.run_evaluation_cache(jm, wins, P, cj, chunk_windows=2, checkpoint_every=3,
                                   sample_window_step=4)
    got = U.run_evaluation_cache(port, wins, P, cp, chunk_windows=2, checkpoint_every=3,
                                 sample_window_step=4, device="cpu")
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape == (NODE, P, 1, S)
        np.testing.assert_allclose(g, w, rtol=1e-6)
    sj, sp = _sidecar(cj), _sidecar(cp)
    assert list(sp) == list(sj)
    assert sp["n_windows_done"] == 6 and sp["complete"] is False
    for k in sj:
        if k in ("pred_mean", "ews"):
            np.testing.assert_allclose(sp[k], sj[k], rtol=1e-6)
        else:
            assert sp[k] == sj[k], k
    assert sorted(p.name for p in cp.parent.iterdir()) == ["pred.pt", "pred.pt.mpv.json"]
    # the cache of either side is read back by the other, with no sweep
    port.calls.clear()
    again = U.run_evaluation_cache(port, wins, P, cj, device="cpu")
    assert port.calls == [] and len(again) == 7
    np.testing.assert_array_equal(again[3], want[3])
    np.testing.assert_array_equal(JU.run_evaluation_cache(jm, wins, P, cp)[3], got[3])
    # max_windows bounds the sweep
    short = U.run_evaluation_cache(port, wins, P, tmp_path / "short.pt", max_windows=2,
                                   device="cpu")
    assert len(short) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partial_is_resumed_across_packages(tmp_path, writer):
    """A `.partial` + `.meta` flushed by one package is resumed by the other:
    only the remaining windows are swept."""
    jm, port = _stubbed_pair()
    wins = _windows(5, seed=1)
    cache = tmp_path / "pred.pt"
    partial = cache.with_name(cache.name + ".partial")
    full = U.batched_window_ensemble(port, wins, P, chunk_windows=5, device="cpu")
    fp = JU._sweep_fingerprint(wins, P, 5)
    assert fp == U._sweep_fingerprint(wins, P, 5)
    if writer == "jax":
        JU._flush_partial(partial, full[:3], fp, 5)
        port.calls.clear()
        got = U.run_evaluation_cache(port, wins, P, cache, chunk_windows=8, device="cpu")
        calls = port.calls
    else:
        U._flush_partial(partial, full[:3], fp, 5)
        got = JU.run_evaluation_cache(jm, wins, P, cache, chunk_windows=8)
        calls = jm.calls
    assert calls == [2 * NODE]
    assert len(got) == 5
    for g, w in zip(got, full):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    assert not partial.exists() and not partial.with_name(partial.name + ".meta").exists()
    assert len(pio.load_tensor_list(cache)) == len(jio.load_tensor_list(cache)) == 5


def test_changed_window_invalidates_the_partial(tmp_path):
    _, port = _stubbed_pair()
    wins = _windows(4, seed=2)
    cache = tmp_path / "pred.pt"
    partial = cache.with_name(cache.name + ".partial")
    full = U.batched_window_ensemble(port, wins, P, device="cpu")
    U._flush_partial(partial, full[:2], U._sweep_fingerprint(wins, P, 4), 4)
    changed = wins.copy()
    changed[3, 0, 0, 0] += 1e-3
    assert U._sweep_fingerprint(changed, P, 4) != U._sweep_fingerprint(wins, P, 4)
    assert U._load_partial(partial, U._sweep_fingerprint(changed, P, 4), 4) == []
    assert len(U._load_partial(partial, U._sweep_fingerprint(wins, P, 4), 4)) == 2
    port.calls.clear()
    U.run_evaluation_cache(port, changed, P, cache, device="cpu")
    assert port.calls == [4 * NODE]  # the stale prefix was discarded
    # a partial with no .meta is the older format and is accepted; junk is not
    partial.write_bytes(b"junk")
    assert U._load_partial(partial, "x", 4) == []


def test_resume_mpv_sweep_completes_a_truncated_sidecar(tmp_path):
    jm, port = _stubbed_pair()
    wins = _windows(6, seed=3)
    cj, cp = tmp_path / "j.pt", tmp_path / "p.pt"
    full = U.batched_window_ensemble(port, wins, P, device="cpu")
    pm, ews = U.summarize_pred_future_list(full, model=port)
    fp = U._sweep_fingerprint(wins, P, 6)
    for mod, cache in ((JU, cj), (U, cp)):
        mod._save_mpv_sidecar(cache, fingerprint=fp, n_total=6, sample_window_step=2,
                              pred_mean=pm[:2], ews=ews[:2], complete=False)
    assert cj.with_name("j.pt.mpv.json").read_text() == cp.with_name("p.pt.mpv.json").read_text()
    port.calls.clear()
    got = U.resume_mpv_sweep(port, wins, P, cp, U._load_mpv_sidecar(cp), 6, chunk_windows=2,
                             checkpoint_every=3, sample_window_step=2, device="cpu")
    want = JU.resume_mpv_sweep(jm, wins, P, cj, JU._load_mpv_sidecar(cj), 6, chunk_windows=2,
                               checkpoint_every=3, sample_window_step=2)
    assert port.calls == [2 * NODE, 2 * NODE, NODE]  # windows 2-4 in two chunks, then 5
    np.testing.assert_allclose(got[1], ews, rtol=1e-6)
    np.testing.assert_allclose(got[0], pm, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    sp, sj = _sidecar(cp), _sidecar(cj)
    assert list(sp) == list(sj) and sp["complete"] is True and sp["n_windows_done"] == 6
    assert not cp.exists()  # the ensemble cache is not materialized
    assert U._load_mpv_sidecar(tmp_path / "absent.pt") is None


def test_batched_window_ensemble_runs_tmdm():
    """A family without g(x) goes through the sweeps: ``has_g`` is read with
    a default and ``use_gx_directly`` reaches NsDiff only."""
    port = TMDMModel(TMDM, device="cpu")
    wins = _windows(3, seed=4)
    port.scaler_fit(wins.reshape(-1, 1))
    for use_gx in (False, True):
        ens = U.batched_window_ensemble(port, wins, P, chunk_windows=2, use_gx_directly=use_gx,
                                        device="cpu")
        assert len(ens) == 3 and ens[0].shape == (NODE, P, 1, S)
        assert all(np.isfinite(e).all() for e in ens)
    mpv, mean = U.fast_mpv_sweep(port, wins, P, chunk_windows=2, device="cpu")
    assert mpv.shape == (3,) and (mpv > 0).all() and np.isfinite(mean).all()
    assert U.bounded_chunk_windows(port, wins, 8) == 8
    port.eval_rows_per_call = 7
    assert U.bounded_chunk_windows(port, wins, 8) == 2


def test_run_nsdiff_g_cache(tmp_path):
    """gx cache of an NsDiff model equals JAX's on carried weights (atol
    1e-4); a model without g(x) gives None."""
    jm = JNsDiff(NSDIFF)
    port = NsDiffModel(NSDIFF, device="cpu")
    port.load_state_dict(jm.state_dict(), strict=True)
    wins = _windows(3, seed=5)
    got = U.run_nsdiff_g_cache(port, wins, tmp_path / "g.pt", device="cpu")
    want = JU.run_nsdiff_g_cache(jm, wins, tmp_path / "gj.pt")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
    np.testing.assert_array_equal(
        U.run_nsdiff_g_cache(port, wins[:1], tmp_path / "g.pt", device="cpu")[2], got[2])
    assert U.run_nsdiff_g_cache(TMDMModel(TMDM, device="cpu"), wins, tmp_path / "t.pt",
                                device="cpu") is None
    with pytest.raises(IndexError):
        U.run_nsdiff_g_cache(port, wins, tmp_path / "g2.pt", device="cpu", pred_dim=1)


def test_load_model_from_dir_loads_a_jax_tmdm_checkpoint(tmp_path):
    """A TMDM checkpoint saved by the JAX package loads through the factory,
    strictly; the LRU returns the same model until the file or the inference
    overrides change."""
    jm = JTMDM(TMDM, seed=2)
    jm.scaler_fit(_windows(2).reshape(-1, 1))
    jio.save_checkpoint(tmp_path, "model_trained", jm.state_dict(), jm.net_param)
    (tmp_path / "model_trained.yaml").write_text(yaml.safe_dump(
        {"net": TMDM, "train": {"train_model_select": None}}))
    port, net_param = U.load_model_from_dir(tmp_path, device="cpu")
    assert isinstance(port, TMDMModel) and net_param["task_model"] == "TMDM"
    sd, want = port.state_dict(), jm.state_dict()
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k], np.asarray(want[k]), err_msg=k)
    net_param["n_z_samples"] = 1  # the caller's copy, not the cached one
    again, fresh_param = U.load_model_from_dir(tmp_path, device="cpu")
    assert again is port and fresh_param["n_z_samples"] == S
    other, _ = U.load_model_from_dir(tmp_path, device="cpu", infer_params={"n_z_samples": 2})
    assert other is not port and other.n_z_samples == 2
    uncached, _ = U.load_model_from_dir(tmp_path, device="cpu", use_cache=False)
    assert uncached is not port
    jio.save_checkpoint(tmp_path, "model_trained", JTMDM(TMDM, seed=3).state_dict(), TMDM)
    retrained, _ = U.load_model_from_dir(tmp_path, device="cpu")
    assert retrained is not port
    # the loaded model samples
    out, _ = port.evaluation_step(_windows(1)[0])
    assert out.shape == (NODE, P, 1, S) and torch.isfinite(out).all()
