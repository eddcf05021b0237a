"""Paper Fig. 4: SLBP model-parameter sensitivity panels.

Counterpart of ``upgdm_tpu/figures/fig4_model_sensitivity.py``: MPV (or
prediction error) curves for NsDiff models trained with different prediction
horizons (NsDiff_pred: w200 p{200,500,1000}) and window lengths
(NsDiff_windows: w{200,500,1000} p200) on the same SLBP trajectory, models on
``--device`` (default: the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval.uncertainty import slbp_sensitivity_ews
from .common import (
    add_common_args,
    ensure_output,
    load_dynamic_record,
    set_nature_style,
    skip_render,
    slbp_source_path,
)

PRED_LENS = (200, 500, 1000)
WINDOW_LENS = (200, 500, 1000)
COLORS = ("#0F4D92", "#42949E", "#9A4D8E")
LINESTYLES = ("-", "--", ":")

__all__ = ["load_sensitivity_data", "main"]


def transition_time(time, data) -> float:
    time = np.asarray(time, float)
    data = np.asarray(data, float)
    window_size = 10
    if len(data) <= window_size:
        return float(time[int(np.argmax(np.abs(data - np.mean(data))))])
    change_score = np.abs(data[window_size:] - data[:-window_size]) / window_size
    return float(time[int(np.argmax(np.abs(change_score)))])


def load_sensitivity_data(ews_root, source_root, data_trend, metric,
                          total_time="1000000.0", d_value="1e-05",
                          pred_lens=PRED_LENS, window_lens=WINDOW_LENS, device=None) -> dict:
    data_path = slbp_source_path(source_root, total_time, data_trend, d_value)
    time_data, series = load_dynamic_record(data_path)
    out = {
        "ts": np.asarray(time_data, float)[::1000],
        "ys": np.asarray(series, np.float32)[::1000, 0],
        "pred_ews": {}, "pred_ews_ts": {}, "win_ews": {}, "win_ews_ts": {},
    }
    for pred_len in pred_lens:
        result = slbp_sensitivity_ews(
            model_root=Path(ews_root) / "NsDiff_pred",
            model_name=f"dataset__w200p{pred_len}st100",
            torch_time_series=series, time_data=time_data, data_trend=data_trend,
            pred_dim=0, device=device,
        )
        values = result["mpv"] if metric == "mpv" else result["prediction_error"]
        out["pred_ews"][pred_len] = np.asarray(values, float)
        out["pred_ews_ts"][pred_len] = np.asarray(result["time_points"])
    for window_len in window_lens:
        result = slbp_sensitivity_ews(
            model_root=Path(ews_root) / "NsDiff_windows",
            model_name=f"dataset__w{window_len}p200st100",
            torch_time_series=series, time_data=time_data, data_trend=data_trend,
            pred_dim=0, device=device,
        )
        values = result["mpv"] if metric == "mpv" else result["prediction_error"]
        out["win_ews"][window_len] = np.asarray(values, float)
        out["win_ews_ts"][window_len] = np.asarray(result["time_points"])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 4: SLBP sensitivity")
    add_common_args(parser)
    parser.add_argument("--metric", choices=["mpv", "prediction_error"], default="mpv")
    # the paper's defaults, overridable so the pipeline also runs on
    # reduced-scale demo trees
    parser.add_argument("--total-time", default="1000000.0")
    parser.add_argument("--d-value", default="1e-05")
    parser.add_argument("--pred-lens", nargs="+", type=int, default=list(PRED_LENS))
    parser.add_argument("--window-lens", nargs="+", type=int, default=list(WINDOW_LENS))
    args = parser.parse_args(argv)
    data = load_sensitivity_data(
        args.ews_root, args.source_root, args.trend, args.metric,
        total_time=args.total_time, d_value=args.d_value,
        pred_lens=tuple(args.pred_lens), window_lens=tuple(args.window_lens),
        device=args.device,
    )
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style()
    tt = transition_time(data["ts"], data["ys"])

    fig, axes = plt.subplots(3, 1, figsize=(6.4, 6.2), sharex=True,
                             gridspec_kw={"hspace": 0.12})
    axes[0].plot(data["ts"], data["ys"], color="#0F4D92", linewidth=1.1)
    axes[0].axvline(tt, color="#B64342", linestyle="--", linewidth=0.9)
    axes[0].set_ylabel("State")
    for (pred_len, values), color, ls in zip(data["pred_ews"].items(), COLORS, LINESTYLES):
        axes[1].plot(data["pred_ews_ts"][pred_len][: len(values)], values, color=color,
                     linestyle=ls, linewidth=1.1, label=f"pred_len={pred_len}")
    axes[1].axvline(tt, color="#B64342", linestyle="--", linewidth=0.9)
    axes[1].set_ylabel(args.metric.upper())
    axes[1].legend(fontsize=8)
    for (window_len, values), color, ls in zip(data["win_ews"].items(), COLORS, LINESTYLES):
        axes[2].plot(data["win_ews_ts"][window_len][: len(values)], values, color=color,
                     linestyle=ls, linewidth=1.1, label=f"windows={window_len}")
    axes[2].axvline(tt, color="#B64342", linestyle="--", linewidth=0.9)
    axes[2].set_ylabel(args.metric.upper())
    axes[2].set_xlabel("Time")
    axes[2].legend(fontsize=8)

    out = ensure_output(args.output_dir)
    png = out / f"fig4_model_sensitivity_{args.metric}_{args.trend}.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
