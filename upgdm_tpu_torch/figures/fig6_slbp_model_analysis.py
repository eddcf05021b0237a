"""Paper Fig. 6: SLBP uncertainty interpretation panels.

Counterpart of ``upgdm_tpu/figures/fig6_slbp_model_analysis.py``: for one
SLBP trajectory, (a) sampling-MPV + intrinsic dimension of the ensemble,
(b) the diffusion model's gx, (c) the pretrain-g-only gx, and (d) the raw
rolling-window variance control, both trends; models on ``--device``
(default: the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval.uncertainty import (
    slbp_gx_analysis,
    slbp_raw_window_variance,
    slbp_sampling_analysis,
)
from .common import (
    TRENDS,
    add_common_args,
    ensure_output,
    load_dynamic_record,
    set_nature_style,
    skip_render,
    slbp_source_path,
)

DIFFUSION_MODEL_NAME = "dataset_w200p200st100"
PREG_MODEL_NAME = "dataset_w200p200st100"
DIFFUSION_CACHE_SUBDIR = None
TOTAL_TIME = "1000000.0"
D_VALUE = "1e-05"

__all__ = ["load_panel_data", "main"]


def load_panel_data(ews_root, source_root, data_trend,
                    total_time=TOTAL_TIME, d_value=D_VALUE, device=None) -> dict:
    data_path = slbp_source_path(source_root, total_time, data_trend, d_value)
    time_data, series = load_dynamic_record(data_path)
    diffusion_root = Path(ews_root) / "NsDiff_machine" / "NsDiff"
    preg_root = Path(ews_root) / "NsDiff_machine" / "preg"

    sampling = slbp_sampling_analysis(
        model_root=diffusion_root, model_name=DIFFUSION_MODEL_NAME,
        torch_time_series=series, time_data=time_data, data_trend=data_trend,
        cache_subdir=DIFFUSION_CACHE_SUBDIR, device=device,
    )
    diffusion_gx = slbp_gx_analysis(
        model_root=diffusion_root, model_name=DIFFUSION_MODEL_NAME,
        torch_time_series=series, time_data=time_data, data_trend=data_trend,
        cache_subdir=DIFFUSION_CACHE_SUBDIR, device=device,
    )
    preg_gx = slbp_gx_analysis(
        model_root=preg_root, model_name=PREG_MODEL_NAME,
        torch_time_series=series, time_data=time_data, data_trend=data_trend,
        device=device,
    )
    raw_variance = slbp_raw_window_variance(series, time_data, device=device)
    return {
        "ts": np.asarray(time_data, float)[::1000],
        "ys": np.asarray(series, np.float32)[::1000, 0],
        "sampling": sampling,
        "diffusion_gx": diffusion_gx,
        "preg_gx": preg_gx,
        "raw_variance": raw_variance,
        "trend": data_trend,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 6: SLBP model analysis")
    add_common_args(parser)
    # the paper's defaults, overridable
    parser.add_argument("--total-time", default=TOTAL_TIME)
    parser.add_argument("--d-value", default=D_VALUE)
    args = parser.parse_args(argv)
    panels = [load_panel_data(args.ews_root, args.source_root, trend,
                              total_time=args.total_time, d_value=args.d_value,
                              device=args.device) for trend in TRENDS]
    if skip_render():
        return
    import matplotlib.pyplot as plt

    set_nature_style()
    fig, axes = plt.subplots(5, len(TRENDS), figsize=(5.6 * len(TRENDS), 9.5),
                             sharex="col", gridspec_kw={"hspace": 0.2})
    axes = np.atleast_2d(axes)
    for col, (trend, panel) in enumerate(zip(TRENDS, panels)):
        axes[0, col].plot(panel["ts"], panel["ys"], color="#0F4D92", linewidth=0.9)
        axes[0, col].set_title(trend)
        if panel["sampling"].get("available"):
            s = panel["sampling"]
            axes[1, col].plot(s["time_points"][: len(s["mpv"])], s["mpv"], ".",
                              color="#B64342", markersize=2.5)
            axes[2, col].plot(s["time_points"][: len(s["intrinsic_dimension"])],
                              s["intrinsic_dimension"], ".", color="#9A4D8E", markersize=2.5)
        g = panel["diffusion_gx"]
        axes[3, col].plot(g["time_points"][: len(g["gx_mpv"])], g["gx_mpv"], ".",
                          color="#42949E", markersize=2.5, label="diffusion gx")
        p = panel["preg_gx"]
        axes[3, col].plot(p["time_points"][: len(p["gx_mpv"])], p["gx_mpv"], ".",
                          color="#E28E2C", markersize=2.5, label="pretrain-g gx")
        rv = panel["raw_variance"]
        axes[4, col].plot(rv["time_points"][: len(rv["variance"])], rv["variance"], ".",
                          color="#4D4D4D", markersize=2.5)
        axes[4, col].set_xlabel("Time")
        if col == 0:
            for i, label in enumerate(
                ["State", "Sampling MPV", "Intrinsic dim", "gx", "Raw window var"]
            ):
                axes[i, 0].set_ylabel(label, fontsize=8)
            axes[3, 0].legend(fontsize=7)
    out = ensure_output(args.output_dir)
    png = out / "fig6_slbp_model_analysis.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(png.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
