"""The MPV sweep: rolling windows -> ensembles -> mean predictive variance.

Counterpart of the sweep and cache-runner subset of
``upgdm_tpu/eval/uncertainty.py``: ``fast_mpv_sweep`` (the engine of
``uncertainty_ews(..., cache_mode="none")``), ``batched_window_ensemble``,
``batched_gx``, the two summarizers, ``load_dynamic_data``,
``load_model_from_dir`` (through the model factory, with a small LRU) and
the cache-first runners ``run_evaluation_cache``, ``resume_mpv_sweep`` and
``run_nsdiff_g_cache`` with their ``.partial``/``.meta`` checkpoints and
``.mpv.json`` sidecars. The file formats are the JAX package's, so either
package resumes a sweep the other began.

Each sweep batches ``chunk_windows`` windows per call (flattened with the
node rows into the batch axis), pads the last chunk to the same shape, and
is double-buffered: chunk i+1 is enqueued on the device before chunk i's
results are read back. MPV is taken in raw space, after the inverse scaler.
The ``uncertainty_ews`` facade, ``run_diffstg_evaluation_cache`` and the
SLBP analyses are not ported yet.
"""
from __future__ import annotations

import hashlib
import json
import sys
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..models.factory import diffusion_models
from ..ops.windows import dynamic_name, normalize_time_series
from ..utils import io as uio
from ..utils.device import resolve_device

__all__ = [
    "summarize_pred_future_list",
    "summarize_nsdiff_g_list",
    "load_dynamic_data",
    "load_model_from_dir",
    "batched_window_ensemble",
    "fast_mpv_sweep",
    "batched_gx",
    "bounded_chunk_windows",
    "run_evaluation_cache",
    "resume_mpv_sweep",
    "run_nsdiff_g_cache",
]


# ---------------------------------------------------------------------------
# Data and model loading
# ---------------------------------------------------------------------------

def _infer_dynamic_type(data_file=None, loaded_data=None):
    if loaded_data is not None and "N_values" in loaded_data:
        return "SLBP"
    if loaded_data is not None and "tp_values" in loaded_data:
        return None
    if data_file is None:
        return None
    text = str(data_file).replace("\\", "/").lower()
    for name in ("slbp", "sis", "neuronal", "biomass"):
        if name in text:
            return dynamic_name(name)
    return None


def load_dynamic_data(data_file, dynamic_type=None):
    """A simulation record as {torch_time_series [Node, T, F], time_data, ...}."""
    loaded = uio.load_pt(data_file)
    inferred = _infer_dynamic_type(data_file=data_file, loaded_data=loaded)
    dynamic_type = dynamic_name(dynamic_type) or inferred
    if "ys_dynamic" not in loaded or "ts_dynamic" not in loaded:
        raise KeyError("data_file must contain 'ys_dynamic' and 'ts_dynamic'.")
    series = normalize_time_series(loaded["ys_dynamic"], dynamic_type=dynamic_type)
    return {
        "torch_time_series": series,
        "time_data": np.asarray(loaded["ts_dynamic"]),
        "dynamic_type": dynamic_type,
        "loaded_data": loaded,
    }


#: Corpus sweeps call the evaluators once per trajectory with the same
#: per-dynamics model directory; without a cache every call rebuilds the
#: model and re-ships its weights to the device. Keyed by checkpoint identity
#: (path + mtime + size), infer_params and device, so retrained checkpoints,
#: differing inference overrides and devices never alias. Small LRU: a corpus
#: alternates between at most a few per-dynamics models.
_MODEL_CACHE: "OrderedDict" = OrderedDict()
_MODEL_CACHE_SIZE = 3


def load_model_from_dir(model_save_file, device=None, infer_params=None,
                        method_config=None, use_cache=True):
    """(model, net_param) from ``<dir>/model_trained`` + its yaml, for any
    ported ``task_model``."""
    device = resolve_device(device)
    model_save_file = Path(model_save_file)
    ckpt = model_save_file / "model_trained"
    key = None
    if use_cache and method_config is None and ckpt.exists():
        st = ckpt.stat()
        key = (
            str(model_save_file.resolve()), st.st_mtime_ns, st.st_size,
            None if infer_params is None else repr(sorted(infer_params.items())),
            str(device),
        )
        hit = _MODEL_CACHE.get(key)
        if hit is not None:
            _MODEL_CACHE.move_to_end(key)
            model, net_param = hit
            # callers may mutate the returned config dict; the model is
            # deliberately shared
            return model, dict(net_param)
    method_config = method_config or uio.read_model_config(model_save_file)
    train_model_select = (method_config.get("train") or {}).get("train_model_select")
    net_param, state_dict = uio.load_checkpoint(ckpt, infer_para=infer_params)
    model = diffusion_models(
        task_model=net_param["task_model"],
        net_param=net_param,
        train_model_select=train_model_select,
        device=device,
    )
    model.load_state_dict(state_dict)
    if key is not None:
        _MODEL_CACHE[key] = (model, dict(net_param))
        while len(_MODEL_CACHE) > _MODEL_CACHE_SIZE:
            _MODEL_CACHE.popitem(last=False)
    return model, net_param


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def _feature_inverse_transform(pred_future: np.ndarray, model=None) -> np.ndarray:
    """Inverse-scale along whichever axis matches the feature count."""
    if model is None or getattr(model, "scaler", None) is None:
        return pred_future
    mean = np.asarray(model.scaler_mean)
    std = np.asarray(model.scaler_std)
    if pred_future.ndim >= 3 and pred_future.shape[-2] == mean.size:
        shape = [1] * pred_future.ndim
        shape[-2] = mean.size
        return pred_future * std.reshape(shape) + mean.reshape(shape)
    if pred_future.shape[-1] == mean.size:
        return pred_future * std + mean
    return pred_future


def summarize_pred_future_list(pred_future_list, model=None):
    """Per-window MPV: mean over (nodes, horizon, F) of the across-sample
    population variance."""
    pred_mean_list, ews_list = [], []
    for pred_future in pred_future_list:
        pf = np.asarray(pred_future)
        pf = _feature_inverse_transform(pf, model=model)
        if pf.ndim == 3:
            pf = pf[None]
        if pf.ndim != 4:
            raise ValueError(
                f"pred_future must have shape [Node, pred_len, F, n_z_samples], got {pf.shape}"
            )
        ews_list.append(pf.var(axis=-1).mean())
        pred_mean_list.append(pf.mean())
    return pred_mean_list, ews_list


def summarize_nsdiff_g_list(g_list, pred_dim=0):
    """gx-MPV: mean over horizon then nodes of gx[..., pred_dim]."""
    ews_list, pred_mean_list = [], []
    for gx in g_list:
        gx = np.asarray(gx)
        if gx.ndim == 2:
            gx = gx[None]
        if gx.ndim != 3:
            raise ValueError("NsDiff-g cache elements must have shape [Node, pred_len, F].")
        if pred_dim >= gx.shape[-1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={gx.shape[-1]}.")
        ews_list.append(gx.mean(axis=1)[:, pred_dim].mean())
        pred_mean_list.append(gx.mean())
    return pred_mean_list, ews_list


# ---------------------------------------------------------------------------
# Batched window sweeps
# ---------------------------------------------------------------------------

def _check_device(model, device):
    want = resolve_device(device)
    if model.device.type != want.type:
        raise ValueError(f"model is on {model.device}, sweep asked for {want}")


def _chunks(model, windows_array, chunk):
    """Yield (scaled [chunk*node, W, F] float32 block, valid count)."""
    n, node, W, F = windows_array.shape
    for start in range(0, n, chunk):
        block = windows_array[start : start + chunk]
        valid = block.shape[0]
        if valid < chunk:  # pad to the fixed chunk shape
            block = np.concatenate([block, np.repeat(block[-1:], chunk - valid, axis=0)], axis=0)
        flat = block.reshape(chunk * node, W, F)
        if model.scaler is not None:
            flat = model.scaler_transform(flat)
        yield np.asarray(flat, np.float32), valid


def _double_buffered(dispatch, drain, chunks):
    pending = None
    for item in chunks:
        nxt = dispatch(*item)
        if pending is not None:
            drain(*pending)
        pending = nxt
    if pending is not None:
        drain(*pending)


def batched_window_ensemble(model, windows_array: np.ndarray, pred_len: int,
                            chunk_windows: int = 8, max_windows=None,
                            use_gx_directly: bool = False, device=None) -> List[np.ndarray]:
    """All rolling windows [n, Node, W, F] -> per-window ensembles, a list of
    [Node, pred_len, F, S] arrays (the cache element contract)."""
    _check_device(model, device)
    n, node, W, F = windows_array.shape
    if max_windows is not None:
        n = min(n, max_windows)
        windows_array = windows_array[:n]
    if n == 0:
        return []
    chunk = min(chunk_windows, n)
    out: List[np.ndarray] = []

    def dispatch(flat, valid):
        if use_gx_directly and getattr(model, "has_g", False):
            # NsDiff-only `_pe` variant: gx replaces the per-step sigma solve
            outs, _ = model.evaluation_step(flat, use_gx_directly=True)
        else:
            outs, _ = model.evaluation_step(flat)
        return outs, valid

    def drain(outs, valid):
        outs = outs.cpu().numpy()[:, -pred_len:, :, :]
        outs = outs.reshape(chunk, node, pred_len, F, outs.shape[-1])
        out.extend(outs[i] for i in range(valid))

    _double_buffered(dispatch, drain, _chunks(model, windows_array, chunk))
    return out


def fast_mpv_sweep(model, windows_array: np.ndarray, pred_len: int,
                   chunk_windows: int = 8, device=None) -> tuple:
    """MPV sweep with the across-sample variance reduced on the device.

    Only two scalars per window leave the device: the mean predictive
    variance and the prediction mean, both inverse-scaled (as
    summarize_pred_future_list). Returns (mpv [n], pred_mean [n]).
    """
    _check_device(model, device)
    n, node, W, F = windows_array.shape
    if n == 0:
        return np.zeros(0), np.zeros(0)
    chunk = min(chunk_windows, n)
    dev = model.device
    scaled = model.scaler is not None
    std = torch.as_tensor(model.scaler_std if scaled else np.ones(F), dtype=torch.float32,
                          device=dev)
    mean = torch.as_tensor(model.scaler_mean if scaled else np.zeros(F), dtype=torch.float32,
                           device=dev)
    mpv_out, mean_out = [], []

    def dispatch(flat, valid):
        outs, _ = model.evaluation_step(flat)
        return mpv_reduce(outs, std, mean, chunk, node, pred_len), valid

    def drain(vm, valid):
        mpv_out.append(vm[0].cpu().numpy()[:valid])
        mean_out.append(vm[1].cpu().numpy()[:valid])

    _double_buffered(dispatch, drain, _chunks(model, windows_array, chunk))
    return np.concatenate(mpv_out), np.concatenate(mean_out)


def mpv_reduce(outs, std, mean, chunk, node, pred_len):
    """[chunk*node, O, F, S] ensembles -> (mpv [chunk], pred_mean [chunk])."""
    F = outs.shape[2]
    outs = outs[:, -pred_len:, :, :]
    outs = outs * std[None, None, :, None] + mean[None, None, :, None]
    var = outs.var(dim=-1, correction=0).reshape(chunk, node, pred_len, F)
    pm = outs.reshape(chunk, node, pred_len, F, -1)
    return var.mean(dim=(1, 2, 3)), pm.mean(dim=(1, 2, 3, 4))


def batched_gx(model, windows_array: np.ndarray, chunk_windows: int = 64,
               device=None) -> List[np.ndarray]:
    """gx for all windows in large batches: list of [Node, pred_len, F]."""
    _check_device(model, device)
    n, node, W, F = windows_array.shape
    if n == 0:
        return []
    chunk = min(chunk_windows, n)
    out = []

    def dispatch(flat, valid):
        return model.gx_fn(flat), valid

    def drain(gx, valid):
        gx = gx.cpu().numpy()
        gx = gx.reshape(chunk, node, gx.shape[-2], gx.shape[-1])
        out.extend(gx[i] for i in range(valid))

    _double_buffered(dispatch, drain, _chunks(model, windows_array, chunk))
    return out


# ---------------------------------------------------------------------------
# Cache-first runners
# ---------------------------------------------------------------------------

def bounded_chunk_windows(model, windows_array, chunk_windows):
    """Per-call window chunk bounded by the model's ``eval_rows_per_call``.

    A family whose sampler's memory and device time per call scale with
    window-rows x draws declares that attribute; network records multiply
    rows by the node count. Models without it keep the caller's chunk.
    """
    cap = getattr(model, "eval_rows_per_call", None)
    if not cap:
        return chunk_windows
    node = windows_array.shape[1]
    return max(1, min(chunk_windows, int(cap) // max(1, node)))


def _sweep_fingerprint(windows_array, pred_len, n) -> str:
    """Content hash binding a ``.partial`` checkpoint to its sweep inputs.

    A resumed sweep concatenates cached and fresh ensembles; if the source
    corpus was regenerated between runs the stale prefix would be wrong, not
    just slow. The hash covers the raw window values plus the sweep geometry,
    so any corpus or windowing change discards the partial."""
    h = hashlib.sha256()
    arr = np.ascontiguousarray(np.asarray(windows_array, dtype=np.float32))
    h.update(repr((arr.shape, int(pred_len), int(n))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _load_partial(partial_path: Path, fingerprint: str, n: int) -> List[np.ndarray]:
    """Resume list from a ``.partial`` if its sidecar fingerprint matches.

    Partials without a ``.meta`` sidecar are accepted (the format before
    fingerprints); a mismatching or unreadable partial is discarded, never
    fatal."""
    meta_path = partial_path.with_name(partial_path.name + ".meta")
    try:
        if meta_path.exists() and meta_path.read_text().strip() != fingerprint:
            return []
        return uio.load_tensor_list(partial_path)[:n]
    except Exception:
        return []


def _flush_partial(partial_path: Path, data: List[np.ndarray], fingerprint: str,
                   n: int) -> None:
    """Atomic (tmp-then-rename) partial checkpoint + fingerprint sidecar."""
    tmp = partial_path.with_name(partial_path.name + ".tmp")
    uio.save_tensor_list(data, tmp)
    tmp.replace(partial_path)
    meta_path = partial_path.with_name(partial_path.name + ".meta")
    meta_tmp = meta_path.with_name(meta_path.name + ".tmp")
    meta_tmp.write_text(fingerprint)
    meta_tmp.replace(meta_path)
    print(f"[sweep] {len(data)}/{n} windows -> {partial_path.name}",
          file=sys.stderr, flush=True)


def _clear_partial(partial_path: Path) -> None:
    partial_path.unlink(missing_ok=True)
    partial_path.with_name(partial_path.name + ".meta").unlink(missing_ok=True)


# The per-window ensemble `.pt` caches are gigabytes and regenerable; the MPV
# summary they reduce to is a few KB. Writing that summary to a
# `<cache>.pt.mpv.json` sidecar at every partial flush makes a half-finished
# sweep resumable at the MPV level (only the remaining windows are
# recomputed) and lets figures render from sidecars alone. The fingerprint
# binds a sidecar to the exact window values and geometry.

def _mpv_sidecar_path(cache_path: Path) -> Path:
    cache_path = Path(cache_path)
    return cache_path.with_name(cache_path.name + ".mpv.json")


def _load_mpv_sidecar(cache_path) -> Optional[dict]:
    p = _mpv_sidecar_path(cache_path)
    if not p.exists():
        return None
    try:
        d = json.loads(p.read_text())
    except Exception:
        return None
    if not isinstance(d, dict) or "ews" not in d or "fingerprint" not in d:
        return None
    return d


def _save_mpv_sidecar(cache_path, *, fingerprint: str, n_total: int,
                      sample_window_step, pred_mean, ews,
                      complete: bool, extra: Optional[dict] = None) -> None:
    payload = {
        "version": 1,
        "fingerprint": fingerprint,
        "n_windows_total": int(n_total),
        "n_windows_done": len(ews),
        "sample_window_step": (None if sample_window_step is None
                               else int(sample_window_step)),
        "pred_mean": [float(v) for v in pred_mean],
        "ews": [float(v) for v in ews],
        "complete": bool(complete),
    }
    if extra:
        payload.update(extra)
    p = _mpv_sidecar_path(cache_path)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(payload))
    tmp.replace(p)


def run_evaluation_cache(
    model, windows_array, pred_len, cache_path, device=None, force_recompute=False,
    max_windows=None, chunk_windows=8, checkpoint_every=32, sample_window_step=None,
):
    """Sweep -> `.pt` ensemble cache, with mid-sweep checkpointing.

    An existing cache is returned as it is. Otherwise, every
    ``checkpoint_every`` windows the finished ensembles are flushed to
    ``<cache>.partial`` (atomically, with a fingerprint ``.meta`` and an
    ``.mpv.json`` sidecar) and a rerun resumes from them instead of
    recomputing the whole trajectory. The partial is deleted once the real
    cache lands; a corrupt or stale partial is discarded, not fatal.
    """
    cache_path = Path(cache_path)
    if cache_path.exists() and not force_recompute:
        return uio.load_tensor_list(cache_path)
    n = len(windows_array)
    if max_windows is not None:
        n = min(n, max_windows)
    partial_path = cache_path.with_name(cache_path.name + ".partial")
    fingerprint = _sweep_fingerprint(windows_array[:n], pred_len, n)
    pred_future_list: List[np.ndarray] = []
    if partial_path.exists() and not force_recompute:
        pred_future_list = _load_partial(partial_path, fingerprint, n)
    while len(pred_future_list) < n:
        stop = min(len(pred_future_list) + max(int(checkpoint_every), 1), n)
        pred_future_list.extend(batched_window_ensemble(
            model, windows_array[len(pred_future_list):stop], pred_len,
            chunk_windows=chunk_windows, device=device,
        ))
        if stop < n:
            _flush_partial(partial_path, pred_future_list, fingerprint, n)
            pm, ews = summarize_pred_future_list(pred_future_list, model=model)
            _save_mpv_sidecar(cache_path, fingerprint=fingerprint, n_total=n,
                              sample_window_step=sample_window_step,
                              pred_mean=pm, ews=ews, complete=False)
    uio.save_tensor_list(pred_future_list, cache_path)
    _clear_partial(partial_path)
    return pred_future_list


def resume_mpv_sweep(model, windows_array, pred_len, cache_path, sidecar, n,
                     chunk_windows=8, checkpoint_every=32,
                     sample_window_step=None, device=None):
    """MPV-level sweep resume from a partial sidecar.

    The ensemble ``.pt``/``.partial`` of the done prefix is gone but the
    sidecar holds its per-window MPVs: compute ensembles only for the
    remaining windows, summarize them with the live model's scaler,
    concatenate, and keep the sidecar flushed. The full ensemble cache is not
    materialized (its prefix no longer exists); the completed sidecar is the
    arm's durable artifact.
    """
    fingerprint = sidecar["fingerprint"]
    pred_mean = [float(v) for v in sidecar["pred_mean"]]
    ews = [float(v) for v in sidecar["ews"]]
    while len(ews) < n:
        stop = min(len(ews) + max(int(checkpoint_every), 1), n)
        chunk = batched_window_ensemble(
            model, windows_array[len(ews):stop], pred_len,
            chunk_windows=chunk_windows, device=device,
        )
        pm_c, ews_c = summarize_pred_future_list(chunk, model=model)
        pred_mean.extend(pm_c)
        ews.extend(ews_c)
        _save_mpv_sidecar(cache_path, fingerprint=fingerprint, n_total=n,
                          sample_window_step=sample_window_step,
                          pred_mean=pred_mean, ews=ews,
                          complete=len(ews) >= n)
        print(f"[sweep] {len(ews)}/{n} windows (mpv-resume) -> "
              f"{_mpv_sidecar_path(cache_path).name}", file=sys.stderr, flush=True)
    return pred_mean, ews


def run_nsdiff_g_cache(
    model, windows_array, cache_path, device=None, pred_dim=0, force_recompute=False,
    max_windows=None,
):
    """gx for all windows -> `.pt` cache; None for a model without g(x)."""
    cache_path = Path(cache_path)
    if cache_path.exists() and not force_recompute:
        return uio.load_tensor_list(cache_path)
    if not getattr(model, "has_g", False):
        return None
    arr = windows_array[:max_windows] if max_windows is not None else windows_array
    g_list = batched_gx(model, arr, device=device)
    for gx in g_list:
        if pred_dim >= gx.shape[-1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={gx.shape[-1]}.")
    uio.save_tensor_list(g_list, cache_path)
    return g_list
