"""The evaluation API: rolling windows -> ensembles -> mean predictive
variance, behind the ``uncertainty_ews`` facade.

Counterpart of ``upgdm_tpu/eval/uncertainty.py``: ``uncertainty_ews`` (a checkpoint directory and a trajectory in, per-window
MPV out, through the `.pt` caches and their `.mpv.json` sidecars or straight
from the device with ``cache_mode="none"``) and the helpers it calls
(``load_sensitivity_model``, the cache paths, ``load_scaler_view``),
``fast_mpv_sweep`` (the engine of ``cache_mode="none"``),
``batched_window_ensemble``, ``batched_gx``, the two summarizers,
``load_dynamic_data``, ``load_model_from_dir`` (through the model factory,
with a small LRU) and the cache-first runners ``run_evaluation_cache``,
``resume_mpv_sweep`` and ``run_nsdiff_g_cache`` with their
``.partial``/``.meta`` checkpoints and ``.mpv.json`` sidecars. The file
formats are the JAX package's, so either package resumes a sweep the other
began or reads the caches the other wrote.

Each sweep batches ``chunk_windows`` windows per call (flattened with the
node rows into the batch axis), pads the last chunk to the same shape, and
is double-buffered: chunk i+1 is enqueued on the device before chunk i's
results are read back. MPV is taken in raw space, after the inverse scaler.
DiffSTG sweeps one window (one graph) at a time through
``run_diffstg_evaluation_cache``, with the same ``.partial`` checkpoints and
sidecars.

The SLBP analyses (``slbp_sensitivity_ews``, ``slbp_sampling_analysis``,
``slbp_gx_analysis``, ``slbp_mpv_analysis``,
``slbp_direct_model_cache_analysis``, ``slbp_raw_window_variance``) run a
model of the ``models/<name>`` layout over the windows of one [T, F]
trajectory, through caches of [pred_len, F, S] ensembles or [pred_len, F]
gx per window under ``<root>/datas/``. Unlike the facade they summarise a
cache as stored, in scaled space, as the JAX package does. Every entry point
takes ``device``; ``None`` is the card. ``plot_single_model_check`` draws a
facade result (matplotlib is imported in the call).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..models.factory import diffusion_models
from ..ops.graph import graphml_to_adjacency
from ..ops.rolling import window_variance_1d
from ..ops.windows import (
    DEFAULT_SAMPLE_WINDOW_STEP,
    DEFAULT_SAMPLING_T,
    NETWORK_DYNAMICS,
    dynamic_name,
    infer_sample_window_step_from_cache,
    normalize_time_series,
    sample_time_series,
    sampling_interval_from_t,
    sliding_windows,
    slbp_sensitivity_windows,
)
from ..utils import io as uio
from ..utils.device import resolve_device

PROJECT_ROOT = Path(os.environ.get("UPGDM_PROJECT_ROOT", Path(__file__).resolve().parents[2]))

__all__ = [
    "PROJECT_ROOT",
    "uncertainty_ews",
    "read_model_config",
    "load_sensitivity_model",
    "default_cache_dir",
    "data_cache_name",
    "resolve_cache_path",
    "resolve_figure_path",
    "load_scaler_view",
    "default_sample_window_step",
    "summarize_pred_future_list",
    "summarize_nsdiff_g_list",
    "normalize_diffstg_pred_future_list",
    "load_dynamic_data",
    "load_model_from_dir",
    "batched_window_ensemble",
    "fast_mpv_sweep",
    "batched_gx",
    "bounded_chunk_windows",
    "run_evaluation_cache",
    "run_diffstg_evaluation_cache",
    "resume_mpv_sweep",
    "run_nsdiff_g_cache",
    "slbp_sensitivity_cache_path",
    "slbp_fig6_cache_path",
    "slbp_fig6_pred_future_gx_cache_path",
    "torch_data_preprocessing_like_slbp",
    "summarize_slbp_sensitivity",
    "summarize_slbp_sampling_for_fig6",
    "summarize_slbp_gx_for_fig6",
    "summarize_slbp_mpv_cache_for_fig5",
    "run_slbp_sensitivity_cache",
    "run_slbp_gx_cache_for_fig6",
    "slbp_sensitivity_ews",
    "slbp_sampling_analysis",
    "slbp_gx_analysis",
    "slbp_mpv_analysis",
    "slbp_direct_model_cache_analysis",
    "slbp_raw_window_variance",
    "plot_single_model_check",
]


# ---------------------------------------------------------------------------
# Data and model loading
# ---------------------------------------------------------------------------

def _resolve_project_path(path):
    if path is None:
        return None
    path = Path(path)
    return path if path.is_absolute() else PROJECT_ROOT / path


def read_model_config(model_save_file) -> dict:
    """The ``model_trained.yaml`` of a checkpoint directory."""
    return uio.read_model_config(model_save_file)


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


def load_sensitivity_model(model_root, model_name, device=None, infer_params=None):
    """(model, method_config, net_param) from the ``models/<name>`` +
    ``models/<name>.yaml`` layout of a sensitivity study."""
    import yaml

    model_root = _resolve_project_path(model_root)
    config_path = model_root / "models" / f"{model_name}.yaml"
    model_path = model_root / "models" / model_name
    if not config_path.exists():
        raise FileNotFoundError(f"model config not found: {config_path}")
    if not model_path.exists():
        raise FileNotFoundError(f"model checkpoint not found: {model_path}")
    with open(config_path, "r", encoding="utf-8") as f:
        method_config = yaml.safe_load(f)
    train_model_select = (method_config.get("train") or {}).get("train_model_select")
    net_param, state_dict = uio.load_checkpoint(model_path, infer_para=infer_params)
    model = diffusion_models(task_model=net_param["task_model"], net_param=net_param,
                             train_model_select=train_model_select, device=device)
    model.load_state_dict(state_dict)
    return model, method_config, net_param


# ---------------------------------------------------------------------------
# Cache paths
# ---------------------------------------------------------------------------

def default_cache_dir(model_save_file, dynamic_type):
    if model_save_file is not None:
        return Path(model_save_file)
    return (PROJECT_ROOT / "ews_results/model_uncertainy_cache/model"
            / (dynamic_name(dynamic_type) or "unknown"))


def data_cache_name(data_file, suffix=""):
    if data_file is None:
        return f"data{suffix}.pt"
    data_path = Path(data_file)
    return f"{data_path.stem}{suffix}{data_path.suffix or '.pt'}"


def resolve_cache_path(cache_path, model_save_file, data_file, dynamic_type, suffix=""):
    """The `.pt` cache of a (checkpoint, trajectory) pair: ``cache_path``
    itself when it names a `.pt`, else a file named after the trajectory in
    ``cache_path`` or the checkpoint directory."""
    if cache_path is None:
        return default_cache_dir(model_save_file, dynamic_type) / data_cache_name(
            data_file, suffix)
    cache_path = _resolve_project_path(cache_path)
    if cache_path.suffix == ".pt":
        return cache_path
    return cache_path / data_cache_name(data_file, suffix)


def resolve_figure_path(cache_file_path):
    return Path(cache_file_path).with_suffix(".png")


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def load_scaler_view(model_save_file):
    """A checkpoint's scaler statistics only: no model is built and no tensor
    goes to a device, so a re-render from caches runs on a machine without a
    card. None when there is no readable checkpoint or it has no fitted
    scaler (the cache is then summarised unscaled)."""
    from types import SimpleNamespace

    try:
        _, sd = uio.load_checkpoint(Path(model_save_file) / "model_trained")
    except (OSError, RuntimeError, ValueError, EOFError, pickle.UnpicklingError):
        return None
    if "scaler_mean" not in sd or "scaler_std" not in sd:
        return None
    return SimpleNamespace(scaler="standard",
                           scaler_mean=np.asarray(sd["scaler_mean"], np.float32),
                           scaler_std=np.asarray(sd["scaler_std"], np.float32))


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


def normalize_diffstg_pred_future_list(pred_future_list):
    """Insert the F axis into legacy [Node, pred_len, samples] caches (ref :354-366)."""
    out = []
    for pf in pred_future_list:
        pf = np.asarray(pf)
        if pf.ndim == 3:
            pf = pf[:, :, None, :]
        if pf.ndim != 4:
            raise ValueError(
                "DiffSTG pred_future must have shape [Node, pred_len, F, samples] "
                f"or legacy [Node, pred_len, samples], got {pf.shape}"
            )
        out.append(pf)
    return out


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
        # C order, as the cache stores it and as JAX hands it back: numpy sums a
        # strided array in another order, and the MPV of a fresh sweep must
        # equal the MPV of the same ensembles read back from its cache
        outs = outs[:, -pred_len:, :, :].contiguous().cpu().numpy()
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


def run_diffstg_evaluation_cache(
    model, windows_array, pred_len, graph, cache_path, device=None,
    force_recompute=False, max_windows=None, checkpoint_every=32,
    sample_window_step=None,
):
    """Per-window DiffSTG sweep -> `.pt` ensemble cache of [Node, pred_len,
    F, S] per window, each window scaled and sampled on ``graph`` (a
    ``DenseGraph``), with the mid-sweep checkpoints of
    :func:`run_evaluation_cache` (atomic ``<cache>.partial`` with its
    fingerprint and ``.mpv.json`` sidecar every ``checkpoint_every``
    windows, resumed on a rerun, cleared once the cache lands)."""
    cache_path = Path(cache_path)
    if cache_path.exists() and not force_recompute:
        return normalize_diffstg_pred_future_list(uio.load_tensor_list(cache_path))
    _check_device(model, device)
    adj = torch.as_tensor(np.asarray(graph.adj, np.float32), device=model.device)
    windows = windows_array[:max_windows] if max_windows is not None else windows_array
    n = len(windows)
    partial_path = cache_path.with_name(cache_path.name + ".partial")
    fingerprint = _sweep_fingerprint(windows, pred_len, n)
    out: List[np.ndarray] = []
    if partial_path.exists() and not force_recompute:
        out = _load_partial(partial_path, fingerprint, n)
    every = max(int(checkpoint_every), 1)
    for i in range(len(out), n):  # [Node, W, F] per window
        x = windows[i]
        if model.scaler is not None:
            x = model.scaler_transform(x)
        pred_future, _ = model.evaluation_step({"x": np.asarray(x, np.float32), "adj": adj})
        # C order, as the cache stores it: numpy's sums run in another order
        # over a strided array, and the MPV of a cache hit must equal this one
        out.append(pred_future[:, -pred_len:, :, :].contiguous().cpu().numpy())
        if len(out) % every == 0 and len(out) < n:
            _flush_partial(partial_path, out, fingerprint, n)
            pm, ews = summarize_pred_future_list(out, model=model)
            _save_mpv_sidecar(cache_path, fingerprint=fingerprint, n_total=n,
                              sample_window_step=sample_window_step,
                              pred_mean=pm, ews=ews, complete=False)
    uio.save_tensor_list(out, cache_path)
    _clear_partial(partial_path)
    return out


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


# ---------------------------------------------------------------------------
# SLBP analyses
# ---------------------------------------------------------------------------

def slbp_fig6_cache_path(model_root, model_name, data_trend, sample_window_step=10,
                         cache_subdir=None, kind="pred_future"):
    cache_dir = _resolve_project_path(model_root) / "datas"
    if cache_subdir:
        cache_dir = cache_dir / cache_subdir
    return cache_dir / f"{model_name}_{kind}_{data_trend}_{sample_window_step}.pt"


def slbp_fig6_pred_future_gx_cache_path(model_root, model_name, data_trend,
                                        sample_window_step=10, cache_subdir=None):
    cache_dir = _resolve_project_path(model_root) / "datas"
    if cache_subdir:
        cache_dir = cache_dir / cache_subdir
    return cache_dir / f"{model_name}_pred_future_{data_trend}_{sample_window_step}_gx.pt"


def slbp_sensitivity_cache_path(model_root, model_name, data_trend, sample_window_step=10):
    """The sensitivity sweep's cache: the sampling analysis's `pred_future`
    cache with no subdirectory, so the two analyses share the file."""
    return slbp_fig6_cache_path(model_root, model_name, data_trend, sample_window_step)


def _legacy_single_underscore_model_name(model_name):
    return str(model_name).replace("dataset__", "dataset_", 1)


def torch_data_preprocessing_like_slbp(time_data, sampling_t, return_numpy=False):
    """The time axis decimated by ``sampling_t`` (numpy, whatever
    ``return_numpy`` says, as in the JAX package)."""
    return np.asarray(time_data)[:: sampling_interval_from_t(sampling_t)]


def _slbp_cache_elements_have_ndim(data_list, ndim):
    return bool(data_list) and all(np.asarray(item).ndim == ndim for item in data_list)


def _slbp_cache_elements_are_gx(data_list):
    """gx caches hold [pred_len, F] (or [1, pred_len, F]) per window;
    sampling caches [pred_len, F, n_z_samples]."""
    return _slbp_cache_elements_have_ndim(data_list, 2) or (
        bool(data_list)
        and all(np.asarray(i).ndim == 3 and np.asarray(i).shape[0] == 1 for i in data_list)
    )


def _slbp_intrinsic_dimension(trajectories):
    """How many principal components cover 80% of the variance of the
    ensemble's trajectories [S, D]. float64 on the host: float32 can flip
    the count where the cumulative share sits at the threshold."""
    t = np.asarray(trajectories, np.float64)
    if t.ndim != 2 or t.shape[0] < 2:
        return np.nan
    centered = t - t.mean(axis=0, keepdims=True)
    cov = centered.T @ centered / max(t.shape[0] - 1, 1)
    eig = np.sort(np.linalg.eigvalsh(cov))[::-1].clip(0)
    total = eig.sum()
    if total <= 0:
        return np.nan
    return int(np.argmax(np.cumsum(eig / total) >= 0.8) + 1)


def summarize_slbp_sensitivity(pred_future_list, pred_datas, model=None, device=None, pred_dim=0):
    """(MPV, prediction error) per window of a sampling cache, both of
    feature ``pred_dim``. The MPV is taken of the cache as stored (scaled
    space); the targets are scaled with the model's scaler to match."""
    mpv_list, pred_error_list = [], []
    for pf in pred_future_list:
        pf = np.asarray(pf)
        if pf.ndim != 3:
            raise ValueError(
                "SLBP sensitivity cache elements must have shape [pred_len, F, n_z_samples].")
        if pred_dim >= pf.shape[1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={pf.shape[1]}.")
        mpv_list.append(pf.var(axis=-1).mean(axis=0)[pred_dim])
    for pf, pd in zip(pred_future_list, pred_datas):
        pf, pd = np.asarray(pf), np.asarray(pd)
        if getattr(model, "scaler", None) is not None:
            pd = model.scaler_transform(pd)
        err = np.abs(pf.mean(axis=-1) - pd).mean(axis=0)
        pred_error_list.append(err[pred_dim])
    return mpv_list, pred_error_list


def summarize_slbp_sampling_for_fig6(pred_future_list, pred_dim=0):
    """(MPV, intrinsic dimension) per window of a sampling cache."""
    mpv_list, dim_list = [], []
    for pf in pred_future_list:
        pf = np.asarray(pf)
        if pf.ndim != 3:
            raise ValueError(
                "SLBP sampling cache elements must have shape [pred_len, F, n_z_samples].")
        if pred_dim >= pf.shape[1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={pf.shape[1]}.")
        mpv_list.append(float(pf.var(axis=-1).mean(axis=0)[pred_dim]))
        traj = pf.transpose(2, 0, 1).reshape(pf.shape[-1], -1)
        dim_list.append(_slbp_intrinsic_dimension(traj))
    return mpv_list, dim_list


def summarize_slbp_gx_for_fig6(gx_list, pred_dim=0):
    """gx-MPV per window: the horizon mean of gx[:, pred_dim]."""
    out = []
    for gx in gx_list:
        gx = np.asarray(gx)
        if gx.ndim == 3 and gx.shape[0] == 1:
            gx = gx[0]
        if gx.ndim != 2:
            raise ValueError(
                "SLBP gx cache elements must have shape [pred_len, F] or [1, pred_len, F].")
        if pred_dim >= gx.shape[-1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={gx.shape[-1]}.")
        out.append(float(gx[:, pred_dim].mean()))
    return out


def summarize_slbp_mpv_cache_for_fig5(data_list, pred_dim=0):
    """(MPV, "sampling" or "gx") of a cache, told apart by its shape."""
    if _slbp_cache_elements_have_ndim(data_list, 3):
        mpv, _dim = summarize_slbp_sampling_for_fig6(data_list, pred_dim=pred_dim)
        return mpv, "sampling"
    if _slbp_cache_elements_are_gx(data_list):
        return summarize_slbp_gx_for_fig6(data_list, pred_dim=pred_dim), "gx"
    shape = tuple(np.asarray(data_list[0]).shape) if data_list else None
    raise ValueError(f"Unsupported SLBP MPV cache element shape: {shape}")


def run_slbp_sensitivity_cache(model, input_windows, cache_path, device=None,
                               force_recompute=False, max_windows=None, chunk_windows=16):
    """SLBP sampling cache: a list of [pred_len, F, n_z_samples], one per
    input window [n, W, F] (``batched_window_ensemble`` with one node). An
    unreadable cache is recomputed."""
    cache_path = Path(cache_path)
    if cache_path.exists() and not force_recompute:
        try:
            return uio.load_tensor_list(cache_path)
        except Exception as exc:
            print(f"warning: failed to read cache {cache_path}, recomputing ({exc})")
    arr = np.asarray(input_windows)[:, None, :, :]  # [n, 1(Node), W, F]
    out = batched_window_ensemble(model, arr, model.pred_len, chunk_windows=chunk_windows,
                                  max_windows=max_windows, device=device)
    out = [pf[0] for pf in out]  # strip the Node axis -> [pred_len, F, S]
    uio.save_tensor_list(out, cache_path)
    return out


def run_slbp_gx_cache_for_fig6(model, input_windows, cache_path, device=None, pred_dim=0,
                               force_recompute=False, max_windows=None):
    """SLBP gx cache: a list of [pred_len, F], one per input window. An
    existing cache is returned only when its elements are gx-shaped."""
    cache_path = Path(cache_path)
    if cache_path.exists() and not force_recompute:
        gx_list = uio.load_tensor_list(cache_path)
        if _slbp_cache_elements_are_gx(gx_list):
            return gx_list
    if not getattr(model, "has_g", False):
        raise ValueError("model does not provide cond_pred_model_g for gx generation.")
    arr = np.asarray(input_windows)[:, None, :, :]
    if max_windows is not None:
        arr = arr[:max_windows]
    g_list = [g[0] for g in batched_gx(model, arr, device=device)]
    for gx in g_list:
        if pred_dim >= gx.shape[-1]:
            raise IndexError(f"pred_dim {pred_dim} out of bounds for F={gx.shape[-1]}.")
    uio.save_tensor_list(g_list, cache_path)
    return g_list


def _slbp_dataset_config(model_root, model_name, windows=None, pred_len=None, sampling_t=None):
    """windows / pred_len / sampling_t: the caller's, else the model yaml's,
    else 200 / 200 / 100."""
    import yaml

    config_path = _resolve_project_path(model_root) / "models" / f"{model_name}.yaml"
    method_config = None
    if config_path.exists():
        with open(config_path, "r", encoding="utf-8") as f:
            method_config = yaml.safe_load(f)
    dataset_config = method_config.get("dataset", {}) if method_config else {}
    return {
        "windows": windows if windows is not None else dataset_config.get("windows", 200),
        "pred_len": pred_len if pred_len is not None else dataset_config.get("pred_len", 200),
        "sampling_t": (sampling_t if sampling_t is not None
                       else dataset_config.get("sampling_t", 100)),
        "method_config": method_config,
    }


def slbp_sensitivity_ews(model_root, model_name, torch_time_series, time_data,
                         data_trend="increase", pred_dim=0, sample_window_step=10,
                         infer_params=None, force_recompute=False, max_windows=None,
                         device=None):
    """Sampling MPV and prediction error per window of an SLBP trajectory
    [T, F] under ``<model_root>/models/<model_name>``, through the cache
    ``slbp_sensitivity_cache_path``. ``device=None`` is the card."""
    model_root = _resolve_project_path(model_root)
    model, method_config, loaded_net_param = load_sensitivity_model(
        model_root, model_name, device=device, infer_params=infer_params)
    dataset_config = method_config.get("dataset", {})
    windows = dataset_config["windows"]
    pred_len = dataset_config["pred_len"]
    sampling_t = dataset_config["sampling_t"]

    input_windows, pred_windows, time_points = slbp_sensitivity_windows(
        np.asarray(torch_time_series), time_data, windows, pred_len, sampling_t,
        sample_window_step)
    cache_path = slbp_sensitivity_cache_path(model_root, model_name, data_trend, sample_window_step)
    pred_future_list = run_slbp_sensitivity_cache(
        model, input_windows, cache_path, device=device,
        force_recompute=force_recompute, max_windows=max_windows)
    mpv_list, prediction_error_list = summarize_slbp_sensitivity(
        pred_future_list, pred_windows, model=model, device=device, pred_dim=pred_dim)
    return {
        "time_points": time_points,
        "mpv": mpv_list,
        "prediction_error": prediction_error_list,
        "pred_future_list": pred_future_list,
        "cache_path": str(cache_path),
        "windows": windows,
        "pred_len": pred_len,
        "sampling_t": sampling_t,
        "sample_window_step": sample_window_step,
        "model_root": str(model_root),
        "model_name": model_name,
        "loaded_net_param": loaded_net_param,
    }


def slbp_sampling_analysis(model_root, model_name, torch_time_series, time_data,
                           data_trend="increase", pred_dim=0, sample_window_step=10,
                           cache_subdir=None, windows=None, pred_len=None, sampling_t=None,
                           infer_params=None, force_recompute=False, max_windows=None,
                           device=None, allow_unavailable=True):
    """Sampling MPV and intrinsic dimension per window. The `pred_future`
    cache is used when it holds sampling ensembles, else the
    `sampling_pred_future` one; a sweep writes whichever is free. With
    ``allow_unavailable`` (the default, as in the JAX package) any failure
    returns ``available: False`` with the reason instead of raising."""
    cfg = _slbp_dataset_config(model_root, model_name, windows, pred_len, sampling_t)
    input_windows, _pred, time_points = slbp_sensitivity_windows(
        np.asarray(torch_time_series), time_data, cfg["windows"], cfg["pred_len"],
        cfg["sampling_t"], sample_window_step)
    cache_path = slbp_fig6_cache_path(
        model_root, model_name, data_trend, sample_window_step, cache_subdir, "pred_future")
    sampling_cache_path = slbp_fig6_cache_path(
        model_root, model_name, data_trend, sample_window_step, cache_subdir,
        "sampling_pred_future")
    try:
        active_cache_path = cache_path
        pred_future_list = None
        if not force_recompute:
            if cache_path.exists():
                candidate = uio.load_tensor_list(cache_path)
                if _slbp_cache_elements_have_ndim(candidate, 3):
                    pred_future_list = candidate
                else:
                    active_cache_path = sampling_cache_path
            if pred_future_list is None and sampling_cache_path.exists():
                candidate = uio.load_tensor_list(sampling_cache_path)
                if _slbp_cache_elements_have_ndim(candidate, 3):
                    pred_future_list = candidate
                    active_cache_path = sampling_cache_path
                else:
                    raise ValueError("sampling cache exists but is not "
                                     f"[pred_len, F, n_z_samples]: {sampling_cache_path}")
        if pred_future_list is None:
            if cache_path.exists() and active_cache_path == cache_path:
                active_cache_path = sampling_cache_path
            model, _mc, _np = load_sensitivity_model(
                model_root, model_name, device=device, infer_params=infer_params)
            pred_future_list = run_slbp_sensitivity_cache(
                model, input_windows, active_cache_path, device=device,
                force_recompute=force_recompute, max_windows=max_windows)
            if not _slbp_cache_elements_have_ndim(pred_future_list, 3):
                raise ValueError("generated sampling cache is not "
                                 f"[pred_len, F, n_z_samples]: {active_cache_path}")
        mpv, intrinsic_dimension = summarize_slbp_sampling_for_fig6(pred_future_list, pred_dim)
        return {
            "available": True,
            "time_points": time_points[: len(mpv)],
            "mpv": mpv,
            "intrinsic_dimension": intrinsic_dimension,
            "pred_future_list": pred_future_list,
            "cache_path": str(active_cache_path),
            "windows": cfg["windows"],
            "pred_len": cfg["pred_len"],
            "sampling_t": cfg["sampling_t"],
            "sample_window_step": sample_window_step,
            "reason": "",
        }
    except Exception as exc:
        if not allow_unavailable:
            raise
        return {
            "available": False,
            "time_points": time_points,
            "mpv": [],
            "intrinsic_dimension": [],
            "pred_future_list": None,
            "cache_path": str(sampling_cache_path if cache_path.exists() else cache_path),
            "windows": cfg["windows"],
            "pred_len": cfg["pred_len"],
            "sampling_t": cfg["sampling_t"],
            "sample_window_step": sample_window_step,
            "reason": str(exc),
        }


def slbp_gx_analysis(model_root, model_name, torch_time_series, time_data,
                     data_trend="increase", pred_dim=0, sample_window_step=10,
                     cache_subdir=None, windows=None, pred_len=None, sampling_t=None,
                     infer_params=None, force_recompute=False, max_windows=None, device=None):
    """gx-MPV per window. Without ``force_recompute`` the first of four
    caches that exists is read: `pred_future_..._gx`, `gx_...`, then
    `pred_future_...` under the model's name and under its legacy
    single-underscore name; the last two serve only when they hold gx (told
    by shape), else gx is computed into the first."""
    cfg = _slbp_dataset_config(model_root, model_name, windows, pred_len, sampling_t)
    input_windows, _pred, time_points = slbp_sensitivity_windows(
        np.asarray(torch_time_series), time_data, cfg["windows"], cfg["pred_len"],
        cfg["sampling_t"], sample_window_step)
    gx_cache_path = slbp_fig6_pred_future_gx_cache_path(
        model_root, model_name, data_trend, sample_window_step, cache_subdir)
    old_gx_cache_path = slbp_fig6_cache_path(
        model_root, model_name, data_trend, sample_window_step, cache_subdir, "gx")
    legacy_cache_path = slbp_fig6_cache_path(
        model_root, model_name, data_trend, sample_window_step, cache_subdir, "pred_future")
    legacy_name_cache_path = slbp_fig6_cache_path(
        model_root, _legacy_single_underscore_model_name(model_name), data_trend,
        sample_window_step, cache_subdir, "pred_future")

    def _generate():
        model, _mc, _np = load_sensitivity_model(
            model_root, model_name, device=device, infer_params=infer_params)
        return run_slbp_gx_cache_for_fig6(
            model, input_windows, gx_cache_path, device=device, pred_dim=pred_dim,
            force_recompute=force_recompute, max_windows=max_windows)

    if gx_cache_path.exists() and not force_recompute:
        gx_list = uio.load_tensor_list(gx_cache_path)
    elif old_gx_cache_path.exists() and not force_recompute:
        gx_list = uio.load_tensor_list(old_gx_cache_path)
        if not _slbp_cache_elements_are_gx(gx_list):
            raise ValueError(f"gx cache exists but is not a gx cache: {old_gx_cache_path}")
        gx_cache_path = old_gx_cache_path
    elif legacy_cache_path.exists() and not force_recompute:
        gx_list = uio.load_tensor_list(legacy_cache_path)
        if _slbp_cache_elements_are_gx(gx_list):
            gx_cache_path = legacy_cache_path
        else:
            gx_list = _generate()
    elif legacy_name_cache_path.exists() and not force_recompute:
        gx_list = uio.load_tensor_list(legacy_name_cache_path)
        if _slbp_cache_elements_are_gx(gx_list):
            gx_cache_path = legacy_name_cache_path
        else:
            gx_list = _generate()
    else:
        gx_list = _generate()

    gx_mpv = summarize_slbp_gx_for_fig6(gx_list, pred_dim=pred_dim)
    return {
        "time_points": time_points[: len(gx_mpv)],
        "gx_mpv": gx_mpv,
        "gx_list": gx_list,
        "cache_path": str(gx_cache_path),
        "windows": cfg["windows"],
        "pred_len": cfg["pred_len"],
        "sampling_t": cfg["sampling_t"],
        "sample_window_step": sample_window_step,
    }


def slbp_mpv_analysis(model_root, model_name, torch_time_series, time_data, cache_path,
                      pred_dim=0, sample_window_step=10, windows=None, pred_len=None,
                      sampling_t=None, infer_params=None, force_recompute=False,
                      max_windows=None, device=None):
    """MPV from an arbitrary cache path, sampling or gx by shape; an
    existing cache gives the window step it was written with (inferred from
    its length), a missing one is swept by sampling."""
    cfg = _slbp_dataset_config(model_root, model_name, windows, pred_len, sampling_t)
    cache_path = _resolve_project_path(cache_path)
    sampled_time = torch_data_preprocessing_like_slbp(time_data, cfg["sampling_t"])

    if cache_path.exists() and not force_recompute:
        data_list = uio.load_tensor_list(cache_path)
        inferred_step = infer_sample_window_step_from_cache(
            len(sampled_time), cfg["windows"], len(data_list), sample_window_step)
        mpv, source = summarize_slbp_mpv_cache_for_fig5(data_list, pred_dim=pred_dim)
        return {
            "time_points": sampled_time[cfg["windows"] - 1 :: inferred_step][: len(mpv)],
            "mpv": mpv,
            "pred_future_list": data_list,
            "cache_path": str(cache_path),
            "windows": cfg["windows"],
            "pred_len": cfg["pred_len"],
            "sampling_t": cfg["sampling_t"],
            "sample_window_step": inferred_step,
            "uncertainty_source": source,
        }

    model, _mc, _np = load_sensitivity_model(
        model_root, model_name, device=device, infer_params=infer_params)
    input_windows, _pred, time_points = slbp_sensitivity_windows(
        np.asarray(torch_time_series), time_data, cfg["windows"], cfg["pred_len"],
        cfg["sampling_t"], sample_window_step)
    pred_future_list = run_slbp_sensitivity_cache(
        model, input_windows, cache_path, device=device,
        force_recompute=force_recompute, max_windows=max_windows)
    mpv, source = summarize_slbp_mpv_cache_for_fig5(pred_future_list, pred_dim=pred_dim)
    return {
        "time_points": time_points[: len(mpv)],
        "mpv": mpv,
        "pred_future_list": pred_future_list,
        "cache_path": str(cache_path),
        "windows": cfg["windows"],
        "pred_len": cfg["pred_len"],
        "sampling_t": cfg["sampling_t"],
        "sample_window_step": sample_window_step,
        "uncertainty_source": source,
    }


def slbp_direct_model_cache_analysis(model_save_file, torch_time_series, time_data, cache_path,
                                     pred_dim=0, sample_window_step=10, cache_kind="auto",
                                     infer_params=None, force_recompute=False, max_windows=None,
                                     device=None, compute_prediction_error=False):
    """MPV from a checkpoint directory and an explicit cache path. A missing
    cache is swept as ``cache_kind`` says ("gx" or "sampling"; "auto" then
    raises). ``compute_prediction_error`` needs a sampling cache."""
    method_config = read_model_config(model_save_file)
    dataset_cfg = method_config.get("dataset", {})
    net_cfg = method_config.get("net", {})
    windows = int(dataset_cfg.get("windows", net_cfg.get("windows", 200)))
    pred_len = int(dataset_cfg.get("pred_len", net_cfg.get("pred_len", 200)))
    sampling_t = int(dataset_cfg.get("sampling_t", 100))
    cache_path = _resolve_project_path(cache_path)
    sampled_time = torch_data_preprocessing_like_slbp(time_data, sampling_t)

    model = None
    if cache_path.exists() and not force_recompute:
        data_list = uio.load_tensor_list(cache_path)
    else:
        if cache_kind not in {"gx", "sampling"}:
            raise ValueError("cache_kind must be 'gx' or 'sampling' when cache is missing.")
        model, _np = load_model_from_dir(model_save_file, device=device,
                                         infer_params=infer_params, method_config=method_config)
        input_windows, _pred, _tp = slbp_sensitivity_windows(
            np.asarray(torch_time_series), time_data, windows, pred_len, sampling_t,
            sample_window_step)
        if cache_kind == "gx":
            data_list = run_slbp_gx_cache_for_fig6(
                model, input_windows, cache_path, device=device, pred_dim=pred_dim,
                force_recompute=force_recompute, max_windows=max_windows)
        else:
            data_list = run_slbp_sensitivity_cache(
                model, input_windows, cache_path, device=device,
                force_recompute=force_recompute, max_windows=max_windows)
    mpv, source = summarize_slbp_mpv_cache_for_fig5(data_list, pred_dim=pred_dim)

    inferred_step = infer_sample_window_step_from_cache(
        len(sampled_time), windows, len(data_list), sample_window_step)
    result = {
        "time_points": sampled_time[windows - 1 :: inferred_step][: len(mpv)],
        "mpv": mpv,
        "pred_future_list": data_list,
        "cache_path": str(cache_path),
        "windows": windows,
        "pred_len": pred_len,
        "sampling_t": sampling_t,
        "sample_window_step": inferred_step,
        "uncertainty_source": source,
    }
    if compute_prediction_error:
        if source != "sampling":
            raise ValueError(f"prediction_error requires a sampling cache, got '{source}'.")
        if model is None:
            model, _np = load_model_from_dir(model_save_file, device=device,
                                             infer_params=infer_params,
                                             method_config=method_config)
        _inp, pred_windows, _tp = slbp_sensitivity_windows(
            np.asarray(torch_time_series), time_data, windows, pred_len, sampling_t,
            inferred_step)
        _mpv, prediction_error = summarize_slbp_sensitivity(
            data_list, pred_windows[: len(data_list)], model=model, device=device,
            pred_dim=pred_dim)
        result["prediction_error"] = prediction_error
    return result


def slbp_raw_window_variance(torch_time_series, time_data, windows=200, sampling_t=100,
                             sample_window_step=10, pred_dim=0, device=None):
    """The raw-series control: the float32 population variance of feature
    ``pred_dim`` over the same strided windows, on ``device`` (None is the
    card)."""
    series = np.asarray(torch_time_series)
    sampled = series[:: sampling_interval_from_t(sampling_t)]
    sampled_time = torch_data_preprocessing_like_slbp(time_data, sampling_t)
    if sampled.ndim != 2:
        raise ValueError("SLBP raw series must have shape [T, F].")
    if pred_dim >= sampled.shape[1]:
        raise IndexError(f"pred_dim {pred_dim} out of bounds for F={sampled.shape[1]}.")
    x = torch.as_tensor(np.ascontiguousarray(sampled[:, pred_dim], dtype=np.float32),
                        device=resolve_device(device))
    variances = window_variance_1d(x, windows, sample_window_step).cpu().numpy()
    time_points = sampled_time[windows - 1 :: sample_window_step][: len(variances)]
    return {
        "time_points": time_points,
        "variance": variances,
        "windows": windows,
        "sampling_t": sampling_t,
        "sample_window_step": sample_window_step,
    }


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

_METHOD_ALIASES = {
    "variance": "sampling", "sampling_variance": "sampling", "pred_future": "sampling",
    "pred": "sampling", "g": "gx", "preg": "gx", "nsdiff_g": "gx",
}


def default_sample_window_step(dynamic_type, task_model=None, dataset_config=None):
    dataset_config = dataset_config or {}
    if task_model == "DiffSTG" and dataset_config.get("interval_step") is not None:
        return dataset_config["interval_step"]
    return DEFAULT_SAMPLE_WINDOW_STEP.get(dynamic_type, 10)


def uncertainty_ews(
    model_save_file=None,
    data_file=None,
    torch_time_series=None,
    time_data=None,
    dynamic_type=None,
    task_model=None,
    graph_file=None,
    cache_path=None,
    sample_window_step=None,
    sampling_t=None,
    infer_params=None,
    pred_dim=0,
    force_recompute=False,
    save_nsdiff_g=True,
    nsdiff_g_path=None,
    uncertainty_method="sampling",
    max_windows=None,
    device=None,
    load_model_when_cached=False,
    chunk_windows=8,
    cache_mode="write",
):
    """Per-window early-warning signal (MPV) of a trajectory under a trained
    model: the JAX package's entry point, for NsDiff (and its variants), TMDM,
    DiffusionTS and DiffSTG (as in the JAX package, NsDiff_spatial has no
    branch: sweep it with ``run_diffstg_evaluation_cache``). DiffusionTS takes
    the generic path with its ``eval_rows_per_call`` (the window chunk) and
    ``eval_checkpoint_every`` (the cache runner's flush interval).
    ``device=None`` is the card.

    DiffSTG needs ``graph_file`` (a ``.graphml``) and network dynamics
    (SIS, neuronal, biomass), and always sweeps through the `.pt` cache
    (``run_diffstg_evaluation_cache``), whatever ``cache_mode``. Without
    ``infer_params`` it loads the checkpoint with the JAX package's default
    ``{"parallel_sampling": 10, "sequential_sampling": 1, "n_z_samples": 10,
    "diffusion_steps": 20}``, which overrides the trained
    ``diffusion_steps`` too (the schedule is rebuilt over 20 steps), as in
    the JAX package.

    ``uncertainty_method``: "sampling" (the ensemble's MPV), "gx" (NsDiff's
    g(x) pathway) or "both", with the JAX package's aliases.
    ``cache_mode="write"`` materialises the `.pt` ensemble cache beside the
    checkpoint (or at ``cache_path``) and summarises it on the host;
    ``"none"`` reduces the MPV on the device (``fast_mpv_sweep``) and
    returns ``pred_future_list`` None. A `.pt` cache wins when present;
    without it a complete `.mpv.json` sidecar whose window fingerprint
    matches serves the MPV, and a partial one resumes the sweep at the MPV
    level. Every path reports raw-space MPV: a cache hit inverts the scaler
    with the checkpoint's statistics alone (``load_scaler_view``). Returns
    the JAX package's dict (``pred_future_list``, ``pred_mean``, ``ews``,
    ``time_points``, the paths, the resolved parameters and, for NsDiff,
    ``nsdiff_g``)."""
    dynamic_type = dynamic_name(dynamic_type)
    uncertainty_method = str(uncertainty_method).lower()
    uncertainty_method = _METHOD_ALIASES.get(uncertainty_method, uncertainty_method)
    if uncertainty_method not in {"sampling", "gx", "both"}:
        raise ValueError("uncertainty_method must be one of: sampling, gx, both.")
    if cache_mode not in {"write", "none"}:
        raise ValueError("cache_mode must be 'write' or 'none'.")

    if data_file is not None:
        data_file = _resolve_project_path(data_file)
        loaded = load_dynamic_data(data_file, dynamic_type=dynamic_type)
        torch_time_series = loaded["torch_time_series"]
        time_data = loaded["time_data"]
        dynamic_type = dynamic_name(dynamic_type) or loaded["dynamic_type"]
    elif torch_time_series is not None:
        torch_time_series = normalize_time_series(torch_time_series, dynamic_type=dynamic_type)
    else:
        raise ValueError("Provide data_file or torch_time_series.")
    if time_data is None:
        raise ValueError("time_data is required when data_file is not provided.")

    method_config = None
    model = None
    loaded_net_param = None
    if model_save_file is not None:
        model_save_file = _resolve_project_path(model_save_file)
        method_config = read_model_config(model_save_file)
    if task_model is None and method_config is not None:
        task_model = method_config.get("net", {}).get("task_model")
    dataset_config = method_config.get("dataset", {}) if method_config else {}
    windows = dataset_config.get("windows")
    pred_len = dataset_config.get("pred_len")
    if windows is None or pred_len is None:
        raise ValueError("model_trained.yaml must provide dataset.windows and dataset.pred_len.")

    cache_path = resolve_cache_path(cache_path, model_save_file, data_file, dynamic_type)
    need_sampling = uncertainty_method in {"sampling", "both"}
    need_gx = uncertainty_method in {"gx", "both"} or (
        save_nsdiff_g and uncertainty_method == "sampling")
    nsdiff_path = None
    if need_gx:
        base = nsdiff_g_path if nsdiff_g_path is not None else cache_path.parent
        nsdiff_path = resolve_cache_path(base, model_save_file, data_file, dynamic_type, "_gx")

    cached_pred = None
    if need_sampling and cache_mode == "write" and cache_path.exists() and not force_recompute:
        cached_pred = uio.load_tensor_list(cache_path)
        if task_model == "DiffSTG":
            cached_pred = normalize_diffstg_pred_future_list(cached_pred)
    cached_g = None
    if need_gx and nsdiff_path.exists() and not force_recompute:
        cached_g = uio.load_tensor_list(nsdiff_path)

    # the MPV sidecars are read only where their ensemble cache is absent,
    # and held to the window fingerprint once the windows exist
    sidecar = gx_sidecar = None
    if not force_recompute:
        if need_sampling and cached_pred is None:
            sidecar = _load_mpv_sidecar(cache_path)
        if need_gx and cached_g is None:
            gx_sidecar = _load_mpv_sidecar(nsdiff_path)
            if gx_sidecar is not None and gx_sidecar.get("pred_dim", 0) != pred_dim:
                gx_sidecar = None

    if sampling_t is None:
        sampling_t = dataset_config.get("sampling_t", DEFAULT_SAMPLING_T.get(dynamic_type, 0.1))
    sampled_series, sampled_time = sample_time_series(
        np.asarray(torch_time_series), time_data, sampling_t)

    step_from_sidecar = False
    fallback_step = default_sample_window_step(dynamic_type, task_model, dataset_config)
    if sample_window_step is None:
        cache_len = (len(cached_pred) if cached_pred is not None
                     else (len(cached_g) if cached_g is not None else None))
        sidecar_step = next((s.get("sample_window_step") for s in (sidecar, gx_sidecar)
                             if s is not None and s.get("sample_window_step")), None)
        if cache_len is not None:
            sample_window_step = infer_sample_window_step_from_cache(
                sampled_series.shape[1], windows, cache_len, fallback_step)
        elif sidecar_step is not None:
            sample_window_step = int(sidecar_step)
            step_from_sidecar = True
        else:
            sample_window_step = fallback_step

    windows_array, time_points = sliding_windows(sampled_series, sampled_time, windows,
                                                 sample_window_step)
    n_arm = len(windows_array) if max_windows is None else min(len(windows_array), max_windows)
    fingerprint = _sweep_fingerprint(windows_array[:n_arm], pred_len, n_arm)
    if sidecar is not None or gx_sidecar is not None:
        if sidecar is not None and sidecar.get("fingerprint") != fingerprint:
            sidecar = None
        if gx_sidecar is not None and gx_sidecar.get("fingerprint") != fingerprint:
            gx_sidecar = None
        if step_from_sidecar and sidecar is None and gx_sidecar is None:
            # the step came from a stale sidecar: the windows at the normal
            # step, as if there had been none
            sample_window_step = fallback_step
            windows_array, time_points = sliding_windows(sampled_series, sampled_time, windows,
                                                         sample_window_step)
            n_arm = (len(windows_array) if max_windows is None
                     else min(len(windows_array), max_windows))
            fingerprint = _sweep_fingerprint(windows_array[:n_arm], pred_len, n_arm)

    def _load_model():
        nonlocal model, loaded_net_param
        if model is None:
            model, loaded_net_param = load_model_from_dir(
                model_save_file, device=device, infer_params=infer_params,
                method_config=method_config)
        return model

    def _chunk():
        return bounded_chunk_windows(model, windows_array, chunk_windows)

    mpv_from_sidecar = False
    pred_future_list, pred_mean_list, uncertainty_ews_list = None, [], []
    if need_sampling:
        if sidecar is not None and sidecar.get("complete"):
            # the ensemble cache is gone, the finished arm's MPV survives
            pred_mean_list = [float(v) for v in sidecar["pred_mean"]]
            uncertainty_ews_list = [float(v) for v in sidecar["ews"]]
            mpv_from_sidecar = True
        elif task_model == "DiffSTG":
            if dynamic_type not in NETWORK_DYNAMICS:
                raise ValueError("DiffSTG only supports network dynamics: SIS, neuronal, biomass.")
            if graph_file is None:
                raise ValueError("graph_file is required for DiffSTG.")
            if cached_pred is not None:
                pred_future_list = cached_pred
                if model_save_file is not None and load_model_when_cached:
                    _load_model()
            elif model_save_file is None:
                raise ValueError("model_save_file is required when cache_path does not exist "
                                 "or force_recompute=True.")
            else:
                if infer_params is None:  # the JAX package's default, steps included
                    infer_params = {"parallel_sampling": 10, "sequential_sampling": 1,
                                    "n_z_samples": 10, "diffusion_steps": 20}
                _load_model()
                graph = graphml_to_adjacency(_resolve_project_path(graph_file))
                pred_future_list = run_diffstg_evaluation_cache(
                    model, windows_array, pred_len, graph, cache_path, device=device,
                    force_recompute=force_recompute, max_windows=max_windows,
                    sample_window_step=sample_window_step)
        elif cached_pred is not None:
            pred_future_list = cached_pred
            if model_save_file is not None and load_model_when_cached:
                _load_model()
        elif model_save_file is None:
            raise ValueError("model_save_file is required when cache_path does not exist, "
                             "force_recompute=True or cache_mode='none'.")
        elif cache_mode == "none":
            _load_model()
            mpv, pm = fast_mpv_sweep(model, windows_array[:n_arm], pred_len,
                                     chunk_windows=_chunk(), device=device)
            pred_mean_list = [float(v) for v in pm]
            uncertainty_ews_list = [float(v) for v in mpv]
        else:
            _load_model()
            ens_partial = cache_path.with_name(cache_path.name + ".partial")
            every = getattr(model, "eval_checkpoint_every", 32)
            if (sidecar is not None and not ens_partial.exists()
                    and 0 < int(sidecar.get("n_windows_done", 0)) < n_arm):
                # the done prefix's ensembles are gone but their MPVs are in
                # the sidecar: resume at the MPV level
                pred_mean_list, uncertainty_ews_list = resume_mpv_sweep(
                    model, windows_array, pred_len, cache_path, sidecar, n_arm,
                    chunk_windows=_chunk(), checkpoint_every=every,
                    sample_window_step=sample_window_step, device=device)
                mpv_from_sidecar = True
            else:
                pred_future_list = run_evaluation_cache(
                    model, windows_array, pred_len, cache_path, device=device,
                    force_recompute=force_recompute, max_windows=max_windows,
                    chunk_windows=_chunk(), checkpoint_every=every,
                    sample_window_step=sample_window_step)
        if pred_future_list is not None:
            summarize_model = model
            if summarize_model is None and model_save_file is not None:
                summarize_model = load_scaler_view(model_save_file)
            pred_mean_list, uncertainty_ews_list = summarize_pred_future_list(
                pred_future_list, model=summarize_model)
        if not mpv_from_sidecar:
            # the arm's durable summary, from a fresh sweep or a `.pt` hit
            raw_space = (pred_future_list is None or model is not None
                         or (model_save_file is not None
                             and load_scaler_view(model_save_file) is not None))
            _save_mpv_sidecar(cache_path, fingerprint=fingerprint, n_total=n_arm,
                              sample_window_step=sample_window_step,
                              pred_mean=pred_mean_list, ews=uncertainty_ews_list,
                              complete=len(uncertainty_ews_list) >= n_arm,
                              extra={"raw_space": bool(raw_space)})

    valid_len = len(uncertainty_ews_list)
    result = {
        "pred_future_list": pred_future_list,
        "pred_mean": pred_mean_list,
        "ews": uncertainty_ews_list,
        "time_points": time_points[:valid_len],
        "cache_path": str(cache_path),
        "figure_path": str(resolve_figure_path(cache_path)),
        "torch_time_series": torch_time_series,
        "time_data": np.asarray(time_data),
        "dynamic_type": dynamic_type,
        "sampling_t": sampling_t,
        "sample_window_step": sample_window_step,
        "windows": windows,
        "pred_len": pred_len,
        "task_model": task_model,
        "uncertainty_method": uncertainty_method,
        "uncertainty_source": "sampling" if need_sampling else None,
        "graph_file": str(_resolve_project_path(graph_file)) if graph_file is not None else None,
        "model_save_file": str(model_save_file) if model_save_file is not None else None,
        "loaded_net_param": loaded_net_param,
    }

    has_g_model = model is not None and getattr(model, "has_g", False)
    g_list = g_summary = None
    if need_gx and ("NsDiff" in str(task_model) or has_g_model):
        if cached_g is not None:
            g_list = cached_g
        elif gx_sidecar is not None and gx_sidecar.get("complete"):
            g_summary = ([float(v) for v in gx_sidecar["pred_mean"]],
                         [float(v) for v in gx_sidecar["ews"]])
        elif (uncertainty_method == "sampling" and model is None and model_save_file is not None
              and not (model_save_file / "model_trained").exists()):
            pass  # sampling came from a cache with no checkpoint: gx is a side artifact
        else:
            if model is None and model_save_file is not None:
                _load_model()
                result["loaded_net_param"] = loaded_net_param
            if model is not None and getattr(model, "has_g", False):
                g_list = run_nsdiff_g_cache(model, windows_array, nsdiff_path, device=device,
                                            pred_dim=pred_dim, force_recompute=force_recompute,
                                            max_windows=max_windows)
        if g_list is not None:
            g_pred_mean, g_ews = summarize_nsdiff_g_list(g_list, pred_dim=pred_dim)
            _save_mpv_sidecar(nsdiff_path, fingerprint=fingerprint, n_total=n_arm,
                              sample_window_step=sample_window_step, pred_mean=g_pred_mean,
                              ews=g_ews, complete=len(g_ews) >= n_arm,
                              extra={"pred_dim": pred_dim})
        elif g_summary is not None:
            g_pred_mean, g_ews = g_summary
        if g_list is not None or g_summary is not None:
            result["nsdiff_g"] = {
                "pred_future_list": g_list,
                "pred_mean": g_pred_mean,
                "ews": g_ews,
                "time_points": time_points[: len(g_ews)],
                "cache_path": str(nsdiff_path),
            }
            if uncertainty_method == "gx":
                result.update(pred_future_list=None, pred_mean=g_pred_mean, ews=g_ews,
                              time_points=time_points[: len(g_ews)],
                              cache_path=str(nsdiff_path),
                              figure_path=str(resolve_figure_path(nsdiff_path)),
                              uncertainty_source="gx")

    if uncertainty_method == "gx" and g_list is None and g_summary is None:
        raise ValueError("uncertainty_method='gx' requires a task_model containing 'NsDiff' "
                         "and a loaded model with cond_pred_model_g, or an existing _gx cache.")
    return result


def plot_single_model_check(result, pred_dim=0, title=None, save_path=None, axs=None):
    """Two panels of an ``uncertainty_ews`` result: the raw state (the node
    mean for network dynamics) and the per-window MPV. matplotlib is
    imported here, not with the module."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    owns_figure = axs is None
    if axs is None:
        fig, axs = plt.subplots(2, 1, figsize=(6.2, 4.2), gridspec_kw={"hspace": 0.0})
    else:
        axs = np.asarray(axs, dtype=object).ravel()
        if len(axs) != 2:
            raise ValueError("plot_single_model_check expects 2 axes.")
        fig = axs[0].figure

    series = np.asarray(result["torch_time_series"])
    time_data = np.asarray(result["time_data"])
    if result.get("dynamic_type") in NETWORK_DYNAMICS:
        y = series[:, :, 0].mean(axis=0)
    else:
        y = series[0, :, pred_dim]

    axs[0].plot(time_data[: len(y)], y, color="#2F5597", linewidth=1.4)
    axs[0].set_ylabel("State")
    if title:
        axs[0].set_title(title)
    axs[1].plot(result["time_points"][: len(result["ews"])], result["ews"], ".",
                color="#C44E52", markersize=3)
    axs[1].set_ylabel("Uncertainty")
    axs[1].set_xlabel("Time")
    axs[1].sharex(axs[0])
    for ax in axs:
        ax.tick_params(labelsize=9)
    if owns_figure:
        fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return fig
