"""Sliding-window construction, decimation and cache-step inference (numpy,
host side).

Counterpart of ``upgdm_tpu/ops/windows.py`` (without the SLBP sensitivity
windows): ``sliding_windows`` stacks every rolling window into one array so
the MPV sweep batches windows on the device; ``sample_time_series``
decimates by the physical sampling period; ``normalize_time_series`` brings
stored records to the canonical ``[Node, T, F]`` layout;
``infer_sample_window_step_from_cache`` recovers the stride a cache was
written with. The per-dynamics defaults are the facade's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NETWORK_DYNAMICS = {"SIS", "neuronal", "biomass"}

DEFAULT_SAMPLE_WINDOW_STEP = {"SIS": 50, "neuronal": 5, "biomass": 5, "SLBP": 10}
DEFAULT_SAMPLING_T = {"SIS": 0.1, "neuronal": 10, "biomass": 10, "SLBP": 100}

__all__ = [
    "NETWORK_DYNAMICS",
    "DEFAULT_SAMPLE_WINDOW_STEP",
    "DEFAULT_SAMPLING_T",
    "dynamic_name",
    "normalize_time_series",
    "sampling_interval_from_t",
    "sample_time_series",
    "sliding_windows",
    "build_sliding_windows_compat",
    "sliding_window_count",
    "infer_sample_window_step_from_cache",
]


def dynamic_name(dynamic_type) -> Optional[str]:
    """Canonicalise a dynamics name."""
    if dynamic_type is None:
        return None
    text = str(dynamic_type)
    return {"sis": "SIS", "slbp": "SLBP", "neuronal": "neuronal", "biomass": "biomass"}.get(
        text.lower(), text
    )


def normalize_time_series(series: np.ndarray, dynamic_type: Optional[str] = None) -> np.ndarray:
    """To canonical [Node, T, F] float32.

    Network dynamics store [T, Node] -> [Node, T, 1]; scalar systems store
    [T, F] -> [1, T, F]; already-3D input passes through.
    """
    dynamic_type = dynamic_name(dynamic_type)
    data = np.asarray(series, dtype=np.float32)
    if data.ndim == 3:
        return data
    if data.ndim != 2:
        raise ValueError("time series must have shape [Node, T, F], [T, F], or [T, Node].")
    if dynamic_type in NETWORK_DYNAMICS:
        return data.T[:, :, None]
    return data[None, :, :]


def sampling_interval_from_t(sampling_t) -> int:
    """Decimation stride from the physical sampling period."""
    sampling_t_min = 0.1
    if sampling_t is None or sampling_t <= sampling_t_min:
        return 1
    return max(1, int(sampling_t / sampling_t_min))


def sample_time_series(series: np.ndarray, time_data, sampling_t) -> Tuple[np.ndarray, np.ndarray]:
    """Decimate a [Node, T, F] series and its time axis."""
    interval = sampling_interval_from_t(sampling_t)
    return series[:, ::interval, :], np.asarray(time_data)[::interval]


def sliding_windows(
    series: np.ndarray, time_data, windows: int, sample_window_step: int
) -> Tuple[np.ndarray, np.ndarray]:
    """All rolling windows as ONE stacked array.

    series: [Node, T, F] -> windows_array [num_windows, Node, windows, F],
    time_points [num_windows] (= time_data[windows-1::step]).
    """
    series = np.asarray(series)
    if series.ndim != 3:
        raise ValueError("series must have shape [Node, T, F].")
    node, T, F = series.shape
    if T < windows:
        raise ValueError(f"T ({T}) is shorter than windows ({windows}).")
    n = (T - windows) // sample_window_step + 1
    starts = np.arange(n) * sample_window_step
    idx = starts[:, None] + np.arange(windows)[None, :]
    out = series[:, idx, :]  # [Node, n, windows, F]
    out = np.ascontiguousarray(np.moveaxis(out, 1, 0))  # [n, Node, windows, F]
    time_points = np.asarray(time_data)[windows - 1 :: sample_window_step][:n]
    return out, time_points


def build_sliding_windows_compat(series, time_data, windows, sample_window_step):
    """``sliding_windows`` as a tuple of per-window [Node, W, F] arrays (the
    reference's signature)."""
    stacked, time_points = sliding_windows(series, time_data, windows, sample_window_step)
    return tuple(stacked), time_points


def sliding_window_count(sampled_length: int, windows: int, sample_window_step: int) -> int:
    """How many windows ``sliding_windows`` makes of a series this long."""
    if sampled_length < windows:
        return 0
    return (sampled_length - windows) // sample_window_step + 1


def infer_sample_window_step_from_cache(sampled_length: int, windows: int, cache_len: int,
                                        fallback_step: int) -> int:
    """The window stride a cache of ``cache_len`` windows was written with:
    ``fallback_step`` when it fits (or nothing does), else the fitting stride
    nearest to it, the larger on a tie."""
    if cache_len <= 0 or sampled_length < windows:
        return fallback_step
    if sliding_window_count(sampled_length, windows, fallback_step) == cache_len:
        return fallback_step
    if cache_len == 1:
        return fallback_step
    max_offset = sampled_length - windows
    low = int(np.floor(max_offset / cache_len)) + 1
    high = int(np.floor(max_offset / (cache_len - 1)))
    candidates = [step for step in range(max(1, low), max(1, high) + 1)
                  if sliding_window_count(sampled_length, windows, step) == cache_len]
    if not candidates:
        return fallback_step
    return min(candidates, key=lambda step: (abs(step - fallback_step), -step))
