"""Shared helpers of the paper-figure scripts.

Counterpart of ``upgdm_tpu/figures/common.py``: the path and name
conventions of the artifact trees, the dataset, trend and graph constants,
the per-dynamics window parameters, the raw-state helpers and the
matplotlib style every figure shares (matplotlib is imported in the call).
The figure CLIs take ``--device`` (default: the card) for the models they
sweep.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
from pathlib import Path

import numpy as np

from ..utils.io import load_pt

PROJECT_ROOT = Path(os.environ.get("UPGDM_PROJECT_ROOT", Path(__file__).resolve().parents[2]))
EWS_ROOT = PROJECT_ROOT / "ews_results"
SOURCE_ROOT = PROJECT_ROOT / "dataset"
OUTPUT_ROOT = PROJECT_ROOT / "paper_figures_outputs"

DATASETS = ("biomass", "neuronal", "SIS")
TRENDS = ("decrease", "increase")
GRAPH_TYPES = ("BA", "ER", "WS")
MODEL_COMPARE_MODELS = ("NsDiff", "DiffSTG")
FIG1_MODELS = ("NsDiff", "DiffSTG", "DiffusionTS", "TMDM")

MODEL_COLORS = {
    "NsDiff": "#B64342",
    "DiffSTG": "#42949E",
    "DiffusionTS": "#9A4D8E",
    "TMDM": "#E28E2C",
}
RAW_COLOR = "#0F4D92"
TRANSITION_COLOR = "#B64342"

__all__ = [
    "PROJECT_ROOT", "EWS_ROOT", "SOURCE_ROOT", "OUTPUT_ROOT", "DATASETS", "TRENDS",
    "GRAPH_TYPES", "MODEL_COMPARE_MODELS", "FIG1_MODELS", "MODEL_COLORS", "RAW_COLOR",
    "TRANSITION_COLOR", "add_common_args", "can_render", "skip_render",
    "select_one_or_all", "dynamics_filename",
    "graph_name", "graph_file", "spdata_source_path", "slbp_source_path",
    "load_dynamic_record", "ensure_output", "dynamics_title", "parameters",
    "set_nature_style", "transition_time", "load_raw_trace", "relative_uncertainty",
    "thin_for_plot",
]


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--ews-root", type=Path, default=EWS_ROOT)
    parser.add_argument("--source-root", type=Path, default=SOURCE_ROOT)
    parser.add_argument("--output-dir", type=Path, default=OUTPUT_ROOT)
    parser.add_argument("--trend", choices=TRENDS, default="increase")
    parser.add_argument("--device", default=None,
                        help="device of the models a figure sweeps (default: the card)")


def select_one_or_all(value, choices):
    return [value] if value else list(choices)


def dynamics_filename(dataset_type: str, data_trend: str) -> str:
    names = {
        "biomass": f"biomass_dynamic_eta0.005r0.7_{data_trend}.pt",
        "neuronal": f"neuronal_dynamic_eta0.01tau2.0_{data_trend}.pt",
        "SIS": f"SIS_dynamic_eta0.0001d0.5_{data_trend}.pt",
    }
    if dataset_type not in names:
        raise ValueError(f"unknown dataset_type: {dataset_type}")
    return names[dataset_type]


def graph_name(graph_type: str) -> str:
    names = {"BA": "barabasi_albert_30_0", "ER": "erdos_renyi_50_0", "WS": "small-world_70_0"}
    if graph_type not in names:
        raise ValueError(f"unknown graph_type: {graph_type}")
    return names[graph_type]


def graph_file(source_root: Path, graph: str) -> Path:
    return Path(source_root) / "test_graph" / f"{graph}.graphml"


def spdata_source_path(source_root, dataset_type, graph, data_name) -> Path:
    return Path(source_root) / f"spdata_sde_{dataset_type}" / graph / data_name


def slbp_source_path(source_root, total_time, data_trend, d_value, test_data=False) -> Path:
    folder = "SLBP_model_data_test" if test_data else "SLBP_model_data"
    return (
        Path(source_root) / folder
        / f"SLBP_dynamic_total_time_{total_time}_N_{data_trend}"
        / f"SLBP_dynamic_D_{d_value}.pt"
    )


def load_dynamic_record(path):
    record = load_pt(path)
    if not isinstance(record, dict) or "ts_dynamic" not in record or "ys_dynamic" not in record:
        raise ValueError(
            f"{path} must be a saved dict with keys 'ts_dynamic' and 'ys_dynamic'."
        )
    return record["ts_dynamic"], record["ys_dynamic"]


def can_render() -> bool:
    """Whether matplotlib is installed: the renders need it, the sweeps and
    tables do not (the card's machine has none)."""
    return importlib.util.find_spec("matplotlib") is not None


def skip_render() -> bool:
    """True, after saying so, when matplotlib is not installed: a figure CLI
    calls it once its loaders have run (sweeps, caches and tables written)
    and returns before it renders."""
    if can_render():
        return False
    print("matplotlib is not installed: the sweeps ran, the render is skipped")
    return True


def ensure_output(path: Path) -> Path:
    Path(path).mkdir(parents=True, exist_ok=True)
    return Path(path)


def dynamics_title(dataset_type: str) -> str:
    titles = {"biomass": "Resource biomass", "neuronal": "Wilson-Cowan neuronal", "SIS": "SIS"}
    if dataset_type not in titles:
        raise ValueError(f"unknown dataset_type: {dataset_type}")
    return titles[dataset_type]


def parameters(dataset_type: str):
    """(sample_window_step, sampling_t) per dynamics."""
    if dataset_type in ("biomass", "neuronal"):
        return 5, 10
    if dataset_type == "SIS":
        return 20, 0.1
    raise ValueError(f"unknown dataset_type: {dataset_type}")


def set_nature_style(font_size: int = 10) -> None:
    import matplotlib as mpl

    mpl.use("Agg")
    mpl.rcParams.update(
        {
            "font.family": "sans-serif",
            "font.sans-serif": ["Arial", "Helvetica", "DejaVu Sans", "sans-serif"],
            "svg.fonttype": "none",
            "pdf.fonttype": 42,
            "font.size": font_size,
            "axes.labelsize": font_size + 1,
            "axes.titlesize": font_size + 2,
            "xtick.labelsize": font_size,
            "ytick.labelsize": font_size,
            "axes.spines.right": False,
            "axes.spines.top": False,
            "axes.linewidth": 0.75,
            "legend.frameon": False,
        }
    )


def transition_time(time, data, dataset_type, data_trend) -> float:
    """Raw-state transition heuristic of fig1."""
    time = np.asarray(time, float)
    data = np.asarray(data, float)
    window_size = 10
    if len(data) <= window_size:
        return float(time[int(np.argmax(np.abs(data - np.mean(data))))])
    if dataset_type in ("biomass", "neuronal"):
        change_score = np.abs(data[window_size:] - data[:-window_size]) / window_size
        idx = int(np.argmax(change_score))
    elif dataset_type == "SIS":
        rolling = np.array([np.mean(data[i : i + window_size]) for i in range(len(data) - window_size)])
        if data_trend == "increase":
            candidates = np.argwhere(rolling > 1e-2).flatten()
        else:
            candidates = np.argwhere(rolling < 1e-2).flatten()
        idx = int(candidates[0]) if len(candidates) else int(np.argmax(np.abs(np.diff(data))))
    else:
        raise ValueError(f"unknown dataset_type: {dataset_type}")
    return float(time[idx])


def load_raw_trace(source_root, dataset_type, data_trend, graph) -> dict:
    """Mean and variance over nodes, and the transition time."""
    data_name = dynamics_filename(dataset_type, data_trend)
    source_path = spdata_source_path(source_root, dataset_type, graph, data_name)
    time_data, ys = load_dynamic_record(source_path)
    ys = np.asarray(ys, np.float32)
    if ys.ndim != 2:
        raise ValueError(f"{source_path} must contain ys_dynamic with shape [T, Node].")
    time = np.asarray(time_data, float)
    mean = ys.mean(axis=1)
    return {
        "data_file": source_path,
        "time": time,
        "mean": mean,
        "variance": ys.var(axis=1),
        "transition_time": transition_time(time, mean, dataset_type, data_trend),
    }


def relative_uncertainty(ews, baseline_fraction=0.1, min_points=5) -> np.ndarray:
    """Normalise by the mean of the first 10% (at least ``min_points``)."""
    ews = np.asarray(ews, float)
    if len(ews) == 0:
        return ews
    n = min(len(ews), max(min_points, int(np.ceil(len(ews) * baseline_fraction))))
    baseline = np.nanmean(ews[:n])
    if not np.isfinite(baseline) or abs(baseline) < np.finfo(float).eps:
        return ews
    return ews / baseline


def thin_for_plot(x, *ys, max_points: int = 1800):
    x = np.asarray(x)
    if len(x) <= max_points:
        return (x, *ys)
    step = int(np.ceil(len(x) / max_points))
    return (x[::step], *(np.asarray(y)[::step] for y in ys))
