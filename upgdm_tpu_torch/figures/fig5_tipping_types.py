"""Paper Fig. 5: SLBP noise and observation-time parameter grid.

Counterpart of ``upgdm_tpu/figures/fig5_tipping_types.py``: MPV panels for
the SLBP model over a grid of noise levels (D values) and trajectory lengths
(total_time rows), both trends, from `NsDiff_trends` caches (a missing cache
is swept on ``--device``, default: the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval.uncertainty import slbp_mpv_analysis
from .common import (
    TRENDS,
    add_common_args,
    ensure_output,
    load_dynamic_record,
    set_nature_style,
    skip_render,
    slbp_source_path,
)

MODEL_NAME = "dataset__w200p200st100"
D_VALUES = ("1e-05", "5e-06")
TIME_ROWS = (("1000000.0", "t1e6", 10), ("2000000.0", "t2e6", 20), ("3000000.0", "t3e6", 30))

__all__ = ["load_panel_data", "main"]


def cache_file(ews_root, cache_folder, d_value, trend) -> Path:
    return Path(ews_root) / "NsDiff_trends" / "datas" / cache_folder / f"D_{d_value}_{trend}.pt"


def load_panel_data(ews_root, source_root, trend, total_time, cache_folder, d_value,
                    sample_window_step, model_name: str = MODEL_NAME, device=None) -> dict:
    data_path = slbp_source_path(source_root, total_time, trend, d_value)
    time_data, series = load_dynamic_record(data_path)
    mpv_result = slbp_mpv_analysis(
        model_root=Path(ews_root) / "NsDiff_trends",
        model_name=model_name,
        torch_time_series=series,
        time_data=time_data,
        cache_path=cache_file(ews_root, cache_folder, d_value, trend),
        sample_window_step=sample_window_step,
        device=device,
    )
    return {
        "ts": np.asarray(time_data, float)[::1000],
        "ys": np.asarray(series, np.float32)[::1000, 0],
        "mpv": np.asarray(mpv_result["mpv"], float),
        "mpv_ts": np.asarray(mpv_result["time_points"]),
        "total_time": total_time,
        "d_value": d_value,
        "trend": trend,
        "cache_path": mpv_result["cache_path"],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 5: tipping types grid")
    add_common_args(parser)
    # the paper's defaults, overridable for reduced-scale demo trees.
    # --time-rows entries: total_time:folder:step
    parser.add_argument("--d-values", nargs="+", default=list(D_VALUES))
    parser.add_argument("--time-rows", nargs="+",
                        default=[f"{t}:{f}:{s}" for t, f, s in TIME_ROWS])
    parser.add_argument("--model-name", default=MODEL_NAME)
    args = parser.parse_args(argv)
    d_values = tuple(args.d_values)
    time_rows = [
        (t, f, int(s)) for t, f, s in (row.split(":") for row in args.time_rows)
    ]
    panels = [[load_panel_data(args.ews_root, args.source_root, trend, total_time,
                               cache_folder, d_value, step, model_name=args.model_name,
                               device=args.device)
               for d_value in d_values for trend in TRENDS]
              for total_time, cache_folder, step in time_rows]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style()
    n_cols = len(d_values) * len(TRENDS)
    fig, axes = plt.subplots(2 * len(time_rows), n_cols,
                             figsize=(2.9 * n_cols, 1.8 * 2 * len(time_rows)),
                             gridspec_kw={"hspace": 0.35})
    axes = np.atleast_2d(axes)
    for row_index, (total_time, cache_folder, step) in enumerate(time_rows):
        col = 0
        for d_value in d_values:
            for trend in TRENDS:
                panel = panels[row_index][col]
                state_row, mpv_row = 2 * row_index, 2 * row_index + 1
                axes[state_row, col].plot(panel["ts"], panel["ys"], color="#0F4D92",
                                          linewidth=0.9)
                axes[mpv_row, col].plot(panel["mpv_ts"][: len(panel["mpv"])], panel["mpv"],
                                        ".", color="#B64342", markersize=2)
                axes[state_row, col].set_xlim(0, float(total_time))
                axes[mpv_row, col].set_xlim(0, float(total_time))
                if row_index == 0:
                    axes[0, col].set_title(f"D={d_value} | {trend}", fontsize=8)
                if col == 0:
                    axes[state_row, col].set_ylabel(f"T={total_time}\nState", fontsize=7)
                    axes[mpv_row, col].set_ylabel("MPV", fontsize=7)
                col += 1
    out = ensure_output(args.output_dir)
    png = out / "fig5_tipping_types.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
