"""Paper Fig. 9: SLBP smoothed-input false-collapse check.

Counterpart of ``upgdm_tpu/figures/fig9_smoothing.py``: a control showing
that causally-smoothed inputs (a moving average that removes the
fluctuations the model reads) produce a false MPV collapse, while raw inputs
do not: gx signals for raw vs causal-moving-average-smoothed windows over
the same trajectory, both noise levels; the model on ``--device`` (default:
the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval.uncertainty import (
    load_sensitivity_model,
    run_slbp_gx_cache_for_fig6,
    summarize_slbp_gx_for_fig6,
)
from ..ops.windows import slbp_sensitivity_windows
from .common import (
    add_common_args,
    ensure_output,
    load_dynamic_record,
    set_nature_style,
    skip_render,
    slbp_source_path,
)

MODEL_NAME = "dataset_w200p200st100"
TOTAL_TIME = "1000000.0"
NOISES = ("1e-05", "5e-06")
PRED_DIM = 0
SAMPLE_WINDOW_STEP = 10

__all__ = ["causal_moving_average", "load_signal", "main"]


def causal_moving_average(series: np.ndarray, window: int = 21, time_axis: int = 0) -> np.ndarray:
    """Trailing moving average: each point is the mean of the last `window`
    observations (shorter at the start)."""
    x = np.moveaxis(np.asarray(series, np.float64), time_axis, 0)
    csum = np.cumsum(x, axis=0)
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        lo = max(0, i - window + 1)
        total = csum[i] - (csum[lo - 1] if lo > 0 else 0)
        out[i] = total / (i - lo + 1)
    return np.moveaxis(out, 0, time_axis).astype(np.float32)


def cache_path(ews_root, noise, trend, smooth, total_time=TOTAL_TIME) -> Path:
    subdir = f"smooth_SLPB_T_{total_time}" if smooth else f"SLPB_{total_time}"
    return (Path(ews_root) / "NsDiff_machine/NsDiff/datas" / subdir
            / f"gx_D_{noise}_{trend}.pt")


def load_signal(ews_root, source_root, noise, trend, smooth: bool,
                total_time=TOTAL_TIME, device=None) -> dict:
    time_data, series = load_dynamic_record(
        slbp_source_path(source_root, total_time, trend, noise)
    )
    model_root = Path(ews_root) / "NsDiff_machine" / "NsDiff"
    model, method_config, _np_ = load_sensitivity_model(model_root, MODEL_NAME, device=device)
    cfg = method_config.get("dataset", {})
    windows, pred_len, sampling_t = cfg["windows"], cfg["pred_len"], cfg["sampling_t"]
    series = np.asarray(series, np.float32)
    if smooth:
        series = causal_moving_average(series, window=max(3, windows // 5), time_axis=0)
    input_windows, _pred, time_points = slbp_sensitivity_windows(
        series, time_data, windows, pred_len, sampling_t, SAMPLE_WINDOW_STEP
    )
    gx_list = run_slbp_gx_cache_for_fig6(
        model, input_windows, cache_path(ews_root, noise, trend, smooth, total_time),
        device=device, pred_dim=PRED_DIM,
    )
    gx_mpv = summarize_slbp_gx_for_fig6(gx_list, pred_dim=PRED_DIM)
    return {
        "plot_time": np.asarray(time_data, float)[::1000],
        "plot_state": series[::1000, PRED_DIM],
        "gx_time": time_points[: len(gx_mpv)],
        "gx_mpv": np.asarray(gx_mpv, float),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 9: smoothing control")
    add_common_args(parser)
    # the paper's defaults, overridable
    parser.add_argument("--total-time", default=TOTAL_TIME)
    parser.add_argument("--noises", nargs="+", default=list(NOISES))
    args = parser.parse_args(argv)
    noises = tuple(args.noises)
    signals = [[load_signal(args.ews_root, args.source_root, noise, args.trend,
                            smooth=smooth, total_time=args.total_time, device=args.device)
                for smooth in (False, True)] for noise in noises]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style(font_size=8)
    fig, axes = plt.subplots(3, len(noises), figsize=(5.4 * len(noises), 6.0),
                             sharex="col", gridspec_kw={"hspace": 0.2})
    axes = np.atleast_2d(axes)
    for col, (noise, (raw, smooth)) in enumerate(zip(noises, signals)):
        axes[0, col].plot(raw["plot_time"], raw["plot_state"], color="#0F4D92",
                          linewidth=0.8, label="raw")
        axes[0, col].plot(smooth["plot_time"], smooth["plot_state"], color="#E28E2C",
                          linewidth=0.8, label="smoothed")
        axes[0, col].set_title(f"D = {noise}")
        axes[1, col].plot(raw["gx_time"], raw["gx_mpv"], ".", color="#B64342", markersize=2)
        axes[2, col].plot(smooth["gx_time"], smooth["gx_mpv"], ".", color="#E28E2C",
                          markersize=2)
        axes[2, col].set_xlabel("Time")
        if col == 0:
            axes[0, 0].set_ylabel("State")
            axes[0, 0].legend(fontsize=7)
            axes[1, 0].set_ylabel("gx (raw input)")
            axes[2, 0].set_ylabel("gx (smoothed input)")
    out = ensure_output(args.output_dir)
    png = out / f"fig9_smoothing_{args.trend}.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
