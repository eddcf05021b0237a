"""Paper Fig. 7: SLBP dataset-constant and mechanism-ablation panels.

Counterpart of ``upgdm_tpu/figures/fig7_train_analysis.py``: gx-MPV for
models trained on constant-parameter null datasets (varied train D / N) and
sampling-MPV + prediction error for the mechanism ablations (wo_gx / wo_fx /
wo_UANS), all on the same SLBP test trajectory; models on ``--device``
(default: the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval.uncertainty import slbp_direct_model_cache_analysis
from .common import (
    add_common_args,
    ensure_output,
    load_dynamic_record,
    set_nature_style,
    skip_render,
    slbp_source_path,
)

TOTAL_TIME = "1000000.0"
TEST_D_VALUE = "1e-05"
PRED_DIM = 0
SAMPLE_WINDOW_STEP = 10
TRAIN_D_PANELS = (
    ("D_0.001", "Train D = 0.001"),
    ("D_0.0001", "Train D = 0.0001"),
    ("D_1e-05", "Train D = 1e-05"),
)
TRAIN_N_PANELS = (
    ("D_0.001_N_0.5", "N = 0.5"),
    ("D_0.001_N_2.5", "N = 2.5"),
    ("D_0.001_N_5", "N = 5"),
)
ABLATION_PANELS = (
    ("wo_gx", "w/o gx"),
    ("wo_fx", "w/o fx"),
    ("wo_UANS", "w/o UANS"),
)

__all__ = ["load_gx_panel", "load_ablation_panel", "main"]


def gx_cache(model_dir: Path, trend: str, total_time=TOTAL_TIME, d_value=TEST_D_VALUE) -> Path:
    return model_dir / f"SLPB_{total_time}" / f"gx_D_{d_value}_{trend}.pt"


def sampling_cache(model_dir: Path, trend: str, total_time=TOTAL_TIME, d_value=TEST_D_VALUE) -> Path:
    return model_dir / f"SLPB_{total_time}" / f"D_{d_value}_{trend}.pt"


def load_gx_panel(ews_root, series, time_data, trend, folder, title,
                  total_time=TOTAL_TIME, d_value=TEST_D_VALUE, device=None) -> dict:
    model_dir = Path(ews_root) / "NsDiff_dataset_contant" / folder
    result = slbp_direct_model_cache_analysis(
        model_save_file=model_dir, torch_time_series=series, time_data=time_data,
        cache_path=gx_cache(model_dir, trend, total_time, d_value), pred_dim=PRED_DIM,
        sample_window_step=SAMPLE_WINDOW_STEP, cache_kind="gx", device=device,
    )
    return {"title": title, "mpv_time": np.asarray(result["time_points"]),
            "mpv": np.asarray(result["mpv"])}


def load_ablation_panel(ews_root, series, time_data, trend, folder, title,
                        total_time=TOTAL_TIME, d_value=TEST_D_VALUE, device=None) -> dict:
    model_dir = Path(ews_root) / "NsDiff_machine" / folder
    result = slbp_direct_model_cache_analysis(
        model_save_file=model_dir, torch_time_series=series, time_data=time_data,
        cache_path=sampling_cache(model_dir, trend, total_time, d_value), pred_dim=PRED_DIM,
        sample_window_step=SAMPLE_WINDOW_STEP, cache_kind="sampling",
        compute_prediction_error=True, device=device,
    )
    return {"title": title, "mpv_time": np.asarray(result["time_points"]),
            "mpv": np.asarray(result["mpv"]),
            "error": np.asarray(result["prediction_error"])}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 7: training/ablation analysis")
    add_common_args(parser)
    # the paper's defaults, overridable
    parser.add_argument("--total-time", default=TOTAL_TIME)
    parser.add_argument("--d-value", default=TEST_D_VALUE)
    args = parser.parse_args(argv)
    tt_d = (args.total_time, args.d_value, args.device)
    time_data, series = load_dynamic_record(
        slbp_source_path(args.source_root, args.total_time, args.trend, args.d_value)
    )
    state_time = np.asarray(time_data, float)[::1000]
    state = np.asarray(series, np.float32)[::1000, PRED_DIM]

    groups = [
        ("train-D", [load_gx_panel(args.ews_root, series, time_data, args.trend, f, t, *tt_d)
                     for f, t in TRAIN_D_PANELS]),
        ("train-N", [load_gx_panel(args.ews_root, series, time_data, args.trend, f, t, *tt_d)
                     for f, t in TRAIN_N_PANELS]),
        ("ablation", [load_ablation_panel(args.ews_root, series, time_data, args.trend, f, t, *tt_d)
                      for f, t in ABLATION_PANELS]),
    ]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style(font_size=8)
    n_cols = max(len(panels) for _g, panels in groups)
    fig, axes = plt.subplots(1 + len(groups), n_cols,
                             figsize=(3.0 * n_cols, 2.0 * (1 + len(groups))),
                             gridspec_kw={"hspace": 0.4})
    axes = np.atleast_2d(axes)
    axes[0, 0].plot(state_time, state, color="#0F4D92", linewidth=0.9)
    axes[0, 0].set_ylabel("State")
    for j in range(1, n_cols):
        axes[0, j].axis("off")
    for gi, (_gname, panels) in enumerate(groups, start=1):
        for pi, panel in enumerate(panels):
            ax = axes[gi, pi]
            ax.plot(panel["mpv_time"][: len(panel["mpv"])], panel["mpv"], ".",
                    color="#B64342", markersize=2)
            ax.set_title(panel["title"], fontsize=8)
            if "error" in panel:
                ax2 = ax.twinx()
                ax2.plot(panel["mpv_time"][: len(panel["error"])], panel["error"], "-",
                         color="#42949E", linewidth=0.8, alpha=0.7)
                ax2.tick_params(labelsize=6)
    out = ensure_output(args.output_dir)
    png = out / f"fig7_train_analysis_{args.trend}.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
