"""Dataset preparation for the flat time-series models: file discovery,
decimation, windowing, flip augmentation.

Counterpart of the time-series half of ``upgdm_tpu/utils/data_prep.py``
(reference utils/utils.py:371-494): windows come out as one stacked
[num, windows + pred_len, F] float32 numpy array. ``pre_dataset_spdata``
(graph corpora) waits for the graph families.
"""
from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Optional

import numpy as np

from .io import load_pt

__all__ = [
    "unfold_windows",
    "flip_augment",
    "pre_dataset_timeseries",
    "pre_dataset_timeseries_real",
]


def unfold_windows(series: np.ndarray, length: int, step: int, axis: int = 0) -> np.ndarray:
    """Strided windows along `axis`: returns [n, ..., length, ...] stacked copy."""
    series = np.asarray(series)
    T = series.shape[axis]
    n = (T - length) // step + 1
    if n <= 0:
        raise ValueError("data length is not enough!!!")
    starts = np.arange(n) * step
    idx = starts[:, None] + np.arange(length)[None, :]
    return np.take(series, idx, axis=axis)  # inserts [n, length] at `axis`


def flip_augment(window: np.ndarray, data_filter: str = "*", file_name: Optional[str] = None,
                 time_axis: int = 0):
    """Trend-aware reversal augmentation (utils/utils.py:377-397).

    '*' -> (flipped, original); '*_increase'/'*_decrease' -> single window,
    flipped when the file's trend doesn't match.
    """
    if data_filter == "*":
        return np.flip(window, axis=time_axis).copy(), window
    trend = data_filter.replace("*_", "")
    if file_name is not None and trend in file_name:
        return (window,)
    return (np.flip(window, axis=time_axis).copy(),)


def _decimation_interval(sampling_t) -> int:
    sampling_t_min = 0.1
    if sampling_t < sampling_t_min:
        raise AssertionError("Error: sampling_t should be greater than or equal to 0.1")
    return int(sampling_t / sampling_t_min)


def _windows_of(file, windows, pred_len, interval_step, interval, STG_exist):
    series = np.asarray(load_pt(file)["ys_dynamic"], np.float32)  # [T, F]
    wins = unfold_windows(series[::interval, :], windows + pred_len, interval_step)  # [n, L, F]
    if STG_exist:  # every feature its own univariate series
        wins = wins.transpose(0, 2, 1).reshape(-1, windows + pred_len, 1)
    return wins


def _kept(wins, data_dropout, rng):
    for w in wins:
        if data_dropout is not None and rng.uniform() > data_dropout:
            continue
        yield w


def _stacked(out, windows, pred_len):
    if not out:
        return np.zeros((0, windows + pred_len, 1), np.float32)
    return np.stack(out).astype(np.float32)


def pre_dataset_timeseries(file_path, windows: int, pred_len: int, interval_step: int,
                           sampling_t: float, filter: str = "*", STG_exist: bool = True,
                           data_dropout: Optional[float] = None,
                           rng: Optional[np.random.Generator] = None, **_) -> np.ndarray:
    """Flat time-series dataset -> stacked [num, windows+pred_len, F] float32.

    Mirrors pre_DataSet_Timeseries (utils/utils.py:399-443): glob
    <file_path>/*/*.pt, decimate by sampling_t/0.1, unfold windows, optionally
    split features into univariate series (STG_exist), apply flip augmentation.
    """
    rng = rng or np.random.default_rng(0)
    interval = _decimation_interval(sampling_t)
    out = []
    for file in sorted(glob(str(Path(file_path) / "*/*.pt"))):
        wins = _windows_of(file, windows, pred_len, interval_step, interval, STG_exist)
        for w in _kept(wins, data_dropout, rng):
            out.extend(flip_augment(w, data_filter=filter, file_name=Path(file).parent.name))
    return _stacked(out, windows, pred_len)


def pre_dataset_timeseries_real(file_path, windows: int, pred_len: int, interval_step: int,
                                sampling_t: float, filter: str = "*", STG_exist: bool = True,
                                data_dropout: Optional[float] = None,
                                rng: Optional[np.random.Generator] = None, **_) -> np.ndarray:
    """Real-data variant (utils/utils.py:447-494): glob
    <file_path>/<filter>/pt/*.pt, no flip augmentation."""
    rng = rng or np.random.default_rng(0)
    interval = _decimation_interval(sampling_t)
    out = []
    for file in sorted(glob(str(Path(file_path) / filter / "pt" / "*.pt"))):
        wins = _windows_of(file, windows, pred_len, interval_step, interval, STG_exist)
        out.extend(_kept(wins, data_dropout, rng))
    return _stacked(out, windows, pred_len)
