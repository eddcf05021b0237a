"""Paper Fig. 2: topology generalization panels.

Counterpart of ``upgdm_tpu/figures/fig2_graph_generalization.py``: a model
trained on one topology family evaluated across BA/ER/WS test graphs for
each dynamics; raw state + MPV per panel, models on ``--device`` (default:
the card).
"""
from __future__ import annotations

import argparse
import gc
from pathlib import Path

import numpy as np

from ..eval.uncertainty import uncertainty_ews
from .common import (
    DATASETS,
    GRAPH_TYPES,
    RAW_COLOR,
    TRANSITION_COLOR,
    add_common_args,
    dynamics_filename,
    dynamics_title,
    ensure_output,
    graph_name,
    load_dynamic_record,
    parameters,
    set_nature_style,
    skip_render,
    spdata_source_path,
    thin_for_plot,
    transition_time,
)

GRAPH_DATA_FALLBACKS = {"WS": "small-world_70_0"}

__all__ = ["load_panel_data", "main"]


def sample_series(time_data, ys_dynamic, sampling_t: float):
    interval = max(1, int(sampling_t / 0.1))
    ts = np.asarray(time_data, float)[::interval]
    ys = np.asarray(ys_dynamic, np.float32)[::interval, :]
    return ts, ys


def load_panel_data(ews_root, source_root, dataset_type, data_trend, graph_type,
                    device=None) -> dict:
    data_name = dynamics_filename(dataset_type, data_trend)
    graph = graph_name(graph_type)
    source_path = spdata_source_path(source_root, dataset_type, graph, data_name)
    time_data, ys_dynamic = load_dynamic_record(source_path)
    sample_window_step, _ = parameters(dataset_type)

    model_root = Path(ews_root) / "ews_generalization" / "graph" / dataset_type
    cache_file = model_root / f"{graph_type}_{data_trend}.pt"
    result = uncertainty_ews(
        model_save_file=model_root,
        data_file=source_path,
        dynamic_type=dataset_type,
        cache_path=cache_file,
        sample_window_step=None if cache_file.exists() else sample_window_step,
        force_recompute=False,
        device=device,
    )
    ts, ys = sample_series(time_data, ys_dynamic, result["sampling_t"])
    data = {
        "ts": ts,
        "ys_mean": ys.mean(axis=1),
        "pred_mean": np.asarray(result["pred_mean"], float),
        "ews": np.asarray(result["ews"], float),
        "ews_ts": np.asarray(result["time_points"]),
        "dynamic_type": dataset_type,
        "data_trend": data_trend,
        "graph_type": graph_type,
    }
    del result
    gc.collect()
    return data


def plot_panel(ax_state, ax_ews, panel: dict):
    ts, mean = thin_for_plot(panel["ts"][: len(panel["ys_mean"])], panel["ys_mean"])
    tt = transition_time(panel["ts"], panel["ys_mean"], panel["dynamic_type"], panel["data_trend"])
    ax_state.plot(ts, mean, color=RAW_COLOR, linewidth=1.2)
    ax_state.axvline(tt, color=TRANSITION_COLOR, linestyle="--", linewidth=0.9)
    ax_ews.plot(panel["ews_ts"][: len(panel["ews"])], panel["ews"], ".",
                color=TRANSITION_COLOR, markersize=2.5)
    ax_ews.axvline(tt, color=TRANSITION_COLOR, linestyle="--", linewidth=0.9)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 2: topology generalization")
    add_common_args(parser)
    parser.add_argument("--graph-types", nargs="+", default=list(GRAPH_TYPES))
    args = parser.parse_args(argv)
    panels = [[load_panel_data(args.ews_root, args.source_root, dataset_type,
                               args.trend, graph_type, device=args.device)
               for graph_type in args.graph_types] for dataset_type in DATASETS]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style()
    n_rows = 2 * len(DATASETS)
    n_cols = len(args.graph_types)
    # x is shared per dynamics row-pair (state/MPV), not per column: the
    # per-dynamics trajectories may span very different time ranges
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(3.0 * n_cols, 1.7 * n_rows),
                             gridspec_kw={"hspace": 0.15})
    axes = np.atleast_2d(axes)
    for row, dataset_type in enumerate(DATASETS):
        for col, graph_type in enumerate(args.graph_types):
            panel = panels[row][col]
            plot_panel(axes[2 * row, col], axes[2 * row + 1, col], panel)
            lo, hi = float(panel["ts"][0]), float(panel["ts"][min(len(panel["ys_mean"]), len(panel["ts"])) - 1])
            axes[2 * row, col].set_xlim(lo, hi)
            axes[2 * row + 1, col].set_xlim(lo, hi)
            if row == 0:
                axes[0, col].set_title(graph_type)
            if col == 0:
                axes[2 * row, col].set_ylabel(f"{dynamics_title(dataset_type)}\nState",
                                              fontsize=8)
                axes[2 * row + 1, col].set_ylabel("MPV", fontsize=8)
    out = ensure_output(args.output_dir)
    png = out / f"fig2_graph_generalization_{args.trend}.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(out / f"fig2_graph_generalization_{args.trend}.pdf", bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
