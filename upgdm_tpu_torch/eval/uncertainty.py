"""The MPV sweep: rolling windows -> ensembles -> mean predictive variance.

Counterpart of the sweep subset of ``upgdm_tpu/eval/uncertainty.py``:
``fast_mpv_sweep`` (the engine of ``uncertainty_ews(..., cache_mode="none")``),
``batched_window_ensemble``, ``batched_gx``, the two summarizers,
``load_dynamic_data`` and a minimal NsDiff ``load_model_from_dir``.

Each sweep batches ``chunk_windows`` windows per call (flattened with the
node rows into the batch axis), pads the last chunk to the same shape, and
is double-buffered: chunk i+1 is enqueued on the device before chunk i's
results are read back. MPV is taken in raw space, after the inverse scaler.
The ``uncertainty_ews`` facade, the prediction caches and the sidecars are
not ported yet.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch

from ..models.nsdiff import NsDiffModel
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


def load_model_from_dir(model_save_file, device=None, infer_params=None):
    """(model, net_param) from ``<dir>/model_trained`` + its yaml (NsDiff)."""
    device = resolve_device(device)
    model_save_file = Path(model_save_file)
    method_config = uio.read_model_config(model_save_file)
    train_model_select = (method_config.get("train") or {}).get(
        "train_model_select", "NsDiff_model")
    net_param, state_dict = uio.load_checkpoint(
        model_save_file / "model_trained", infer_para=infer_params
    )
    if net_param.get("task_model") != "NsDiff":
        raise NotImplementedError(
            f"task_model={net_param.get('task_model')!r}: only NsDiff is ported")
    model = NsDiffModel(net_param, train_model_select=train_model_select, device=device)
    model.load_state_dict(state_dict)
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
        outs, _ = model.evaluation_step(flat, use_gx_directly=use_gx_directly and model.has_g)
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
