"""Dataset preparation for the flat time-series models: file discovery,
decimation, windowing, flip augmentation.

Counterpart of ``upgdm_tpu/utils/data_prep.py`` (reference
utils/utils.py:310-494): flat windows come out as one stacked
[num, windows + pred_len, F] float32 numpy array; graph corpora
(``pre_dataset_spdata``) as [num, V, windows + pred_len, 1] with the padded
adjacencies and the graph of each window.
"""
from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.graph import graphml_to_adjacency
from .io import load_pt

__all__ = [
    "unfold_windows",
    "flip_augment",
    "pre_dataset_timeseries",
    "pre_dataset_timeseries_real",
    "pre_dataset_spdata",
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


def pre_dataset_spdata(spdata_file_path, graph_file_path, windows: int, pred_len: int,
                       interval_step: int, sampling_t: float, filter: str = "*",
                       **_) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Graph dataset -> (x [num, V, L, 1], adjs [G, V, V], graph_ids [num]).

    Mirrors pre_DataSet_spdata (utils/utils.py:310-370): each trajectory
    directory <spdata_file_path>/<name> pairs with
    <graph_file_path>/<name>.graphml; its records hold ys_dynamic [T, Node].
    Every graph is padded to the largest node count (padded nodes have zero
    adjacency rows and zero features); every window is
    emitted flipped, then original (:371-375). A non-finite record raises:
    a diverged simulation would otherwise poison a whole batch.
    """
    dirs = [d for d in sorted(glob(str(Path(spdata_file_path) / filter))) if Path(d).is_dir()]
    interval = _decimation_interval(sampling_t)
    L = windows + pred_len

    graphs, windows_per_graph = [], []
    for d in dirs:
        graph = graphml_to_adjacency(Path(graph_file_path) / f"{Path(d).name}.graphml")
        wins_for_graph = []
        for spdata_file in sorted(glob(str(Path(d) / "*.pt"))):
            series = np.asarray(load_pt(spdata_file)["ys_dynamic"], np.float32).T[:, :, None]
            if not np.isfinite(series).all():
                raise ValueError(f"non-finite ys_dynamic in {spdata_file}: regenerate the "
                                 "record (divergence-guarded simulate_network_system)")
            wins = unfold_windows(series[:, ::interval, :], L, interval_step, axis=1)
            for w in wins.transpose(1, 0, 2, 3):  # [n, V, L, 1]
                wins_for_graph.extend([np.flip(w, axis=1).copy(), w])
        graphs.append(graph)
        windows_per_graph.append(wins_for_graph)

    if not graphs:
        return (np.zeros((0, 0, L, 1), np.float32), np.zeros((0, 0, 0), np.float32),
                np.zeros((0,), np.int32))
    vmax = max(g.num_nodes for g in graphs)
    xs, gids = [], []
    for gi, wins in enumerate(windows_per_graph):
        for w in wins:
            if w.shape[0] < vmax:
                w = np.concatenate([w, np.zeros((vmax - w.shape[0],) + w.shape[1:], w.dtype)])
            xs.append(w)
            gids.append(gi)
    return (np.stack(xs).astype(np.float32), np.stack([g.padded(vmax).adj for g in graphs]),
            np.asarray(gids, np.int32))
