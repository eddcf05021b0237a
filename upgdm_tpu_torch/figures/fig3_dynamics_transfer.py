"""Paper Fig. 3: dynamics generalization panels.

Counterpart of ``upgdm_tpu/figures/fig3_dynamics_transfer.py``: models
trained on each dynamics, evaluated across all dynamics on BA-30; overlaid
MPV signals per trained-on source, models on ``--device`` (default: the
card).
"""
from __future__ import annotations

import argparse
import gc
from pathlib import Path

import numpy as np

from ..eval.uncertainty import uncertainty_ews
from .common import (
    DATASETS,
    MODEL_COLORS,
    RAW_COLOR,
    TRANSITION_COLOR,
    add_common_args,
    dynamics_filename,
    dynamics_title,
    ensure_output,
    load_dynamic_record,
    parameters,
    relative_uncertainty,
    set_nature_style,
    skip_render,
    spdata_source_path,
    thin_for_plot,
    transition_time,
)

TRAINED_COLORS = {"biomass": "#B64342", "neuronal": "#42949E", "SIS": "#E28E2C"}

__all__ = ["load_panel_data", "main"]


def load_panel_data(ews_root, source_root, dataset_type, data_trend, device=None) -> dict:
    data_name = dynamics_filename(dataset_type, data_trend)
    source_path = spdata_source_path(source_root, dataset_type, "barabasi_albert_30_0", data_name)
    time_data, ys_dynamic = load_dynamic_record(source_path)
    sample_window_step, sample_ts = parameters(dataset_type)

    model_signals = {}
    for trained_on in DATASETS:
        model_root = Path(ews_root) / "ews_generalization" / "dynamic" / trained_on
        cache_file = model_root / data_name
        result = uncertainty_ews(
            model_save_file=model_root,
            data_file=source_path,
            dynamic_type=dataset_type,
            cache_path=cache_file,
            sample_window_step=None if cache_file.exists() else sample_window_step,
            sampling_t=sample_ts,
            force_recompute=False,
            device=device,
        )
        model_signals[trained_on] = {
            "ews": np.asarray(result["ews"], float),
            "ews_ts": np.asarray(result["time_points"]),
        }
        del result
        gc.collect()

    interval = max(1, int(sample_ts / 0.1))
    ts = np.asarray(time_data, float)[::interval]
    ys = np.asarray(ys_dynamic, np.float32)[::interval, :]
    return {
        "ts": ts,
        "ys_mean": ys.mean(axis=1),
        "models": model_signals,
        "dynamic_type": dataset_type,
        "data_trend": data_trend,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 3: dynamics transfer")
    add_common_args(parser)
    args = parser.parse_args(argv)
    panels = [load_panel_data(args.ews_root, args.source_root, dataset_type, args.trend,
                              device=args.device) for dataset_type in DATASETS]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style()
    n_cols = len(DATASETS)
    fig, axes = plt.subplots(2, n_cols, figsize=(3.2 * n_cols, 4.6), sharex="col",
                             gridspec_kw={"hspace": 0.1})
    for col, (dataset_type, panel) in enumerate(zip(DATASETS, panels)):
        tt = transition_time(panel["ts"], panel["ys_mean"], dataset_type, args.trend)
        ts, mean = thin_for_plot(panel["ts"][: len(panel["ys_mean"])], panel["ys_mean"])
        axes[0, col].plot(ts, mean, color=RAW_COLOR, linewidth=1.2)
        axes[0, col].axvline(tt, color=TRANSITION_COLOR, linestyle="--", linewidth=0.9)
        axes[0, col].set_title(dynamics_title(dataset_type))
        for trained_on, sig in panel["models"].items():
            rel = relative_uncertainty(sig["ews"])
            axes[1, col].plot(sig["ews_ts"][: len(rel)], rel,
                              color=TRAINED_COLORS[trained_on], linewidth=1.1,
                              label=f"trained on {trained_on}")
        axes[1, col].axvline(tt, color=TRANSITION_COLOR, linestyle="--", linewidth=0.9)
        axes[1, col].set_xlabel("Time")
        if col == 0:
            axes[0, col].set_ylabel("State")
            axes[1, col].set_ylabel("Relative uncertainty")
            axes[1, col].legend(fontsize=7)
    out = ensure_output(args.output_dir)
    png = out / f"fig3_dynamics_transfer_{args.trend}.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(out / f"fig3_dynamics_transfer_{args.trend}.pdf", bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
