"""Paper Fig. 8: SLBP training-source comparison.

Counterpart of ``upgdm_tpu/figures/fig8_train_source.py``: gx-MPV of models
trained on decrease-only / increase-only / both trends, evaluated on both
test trends; the training segment is shaded. Models run on ``--device``
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
D_VALUE = "1e-05"
PRED_DIM = 0
SAMPLE_WINDOW_STEP = 10
TRAIN_START = 0.0
TRAIN_END = 500000.0
MODEL_PANELS = (
    ("1000000.0_radio_0.5_decrease", "Decrease-Trained", ("decrease",)),
    ("1000000.0_radio_0.5_increase", "Increase-Trained", ("increase",)),
    ("1000000.0_N__radio_0.5_all", "Both-Trained", ("decrease", "increase")),
)
TRENDS = ("decrease", "increase")

__all__ = ["load_mpv", "main"]


def gx_cache_path(model_dir: Path, trend: str, total_time=TOTAL_TIME, d_value=D_VALUE) -> Path:
    return model_dir / f"SLPB_{total_time}" / f"gx_D_{d_value}_{trend}.pt"


def load_slbp_record(source_root, trend, total_time=TOTAL_TIME, d_value=D_VALUE) -> dict:
    time_data, series = load_dynamic_record(
        slbp_source_path(source_root, total_time, trend, d_value)
    )
    return {
        "time_data": time_data,
        "series": series,
        "plot_time": np.asarray(time_data, float)[::1000],
        "plot_state": np.asarray(series, np.float32)[::1000, PRED_DIM],
    }


def load_mpv(model_dir, record, trend, total_time=TOTAL_TIME, d_value=D_VALUE,
             device=None) -> dict:
    result = slbp_direct_model_cache_analysis(
        model_save_file=model_dir, torch_time_series=record["series"],
        time_data=record["time_data"],
        cache_path=gx_cache_path(Path(model_dir), trend, total_time, d_value),
        pred_dim=PRED_DIM, sample_window_step=SAMPLE_WINDOW_STEP, cache_kind="gx",
        device=device,
    )
    return {"time": np.asarray(result["time_points"], float),
            "mpv": np.asarray(result["mpv"], float),
            "cache_path": result["cache_path"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 8: training-source comparison")
    add_common_args(parser)
    # the paper's defaults, overridable
    parser.add_argument("--total-time", default=TOTAL_TIME)
    parser.add_argument("--d-value", default=D_VALUE)
    parser.add_argument("--train-end", type=float, default=TRAIN_END,
                        help="right edge of the training-span shading")
    args = parser.parse_args(argv)
    records = {trend: load_slbp_record(args.source_root, trend, args.total_time, args.d_value)
               for trend in TRENDS}
    signals = {(trend, folder): load_mpv(Path(args.ews_root) / "NsDiff_dataset" / folder,
                                         records[trend], trend, args.total_time,
                                         args.d_value, args.device)
               for trend in TRENDS for folder, _, _ in MODEL_PANELS}
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style(font_size=8)
    n_rows = 1 + len(MODEL_PANELS)
    fig, axes = plt.subplots(n_rows, len(TRENDS), figsize=(5.4 * len(TRENDS), 2.0 * n_rows),
                             sharex="col", gridspec_kw={"hspace": 0.25})
    axes = np.atleast_2d(axes)
    for col, trend in enumerate(TRENDS):
        rec = records[trend]
        axes[0, col].plot(rec["plot_time"], rec["plot_state"], color="#0F4D92", linewidth=0.9)
        axes[0, col].set_title(f"test trend: {trend}")
        for row, (folder, label, shaded_trends) in enumerate(MODEL_PANELS, start=1):
            sig = signals[trend, folder]
            ax = axes[row, col]
            ax.plot(sig["time"][: len(sig["mpv"])], sig["mpv"], ".",
                    color="#B64342", markersize=2)
            if trend in shaded_trends:
                ax.axvspan(TRAIN_START, args.train_end, color="#D8D8D8", alpha=0.35, linewidth=0)
            if col == 0:
                ax.set_ylabel(label, fontsize=8)
        axes[-1, col].set_xlabel("Time")
    out = ensure_output(args.output_dir)
    png = out / "fig8_train_source_comparison.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
