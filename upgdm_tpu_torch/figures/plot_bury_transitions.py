"""Plot empirical Bury-2021 records with their transition points marked.

Counterpart of ``upgdm_tpu/figures/plot_bury_transitions.py`` (no model:
the records' own transition fields).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..utils.io import load_pt
from .common import OUTPUT_ROOT, ensure_output, set_nature_style

__all__ = ["transition_x", "channel_labels", "main"]


def transition_x(record):
    ts = np.asarray(record["ts_dynamic"], float).ravel()
    if "transition_index" in record:
        idx = max(0, min(int(record["transition_index"]), len(ts) - 1))
        return float(ts[idx])
    if "transition_time" in record:
        return float(record["transition_time"])
    if "transition_age" in record:
        age = float(record["transition_age"])
        return float(ts[int(np.argmin(np.abs(ts - age)))])
    return None


def channel_labels(record):
    data_type = record.get("data_type", "")
    if data_type == "anoxia":
        return ["Mo", "U"]
    if data_type == "thermoacoustic":
        return ["Pressure"]
    if data_type == "paleoclimate":
        return ["Proxy"]
    return [f"dim {i}" for i in range(np.asarray(record["ys_dynamic"]).shape[1])]


def main(argv=None):
    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser(description="Bury real-data transition points")
    parser.add_argument("--files", nargs="+", required=True, help=".pt record paths")
    parser.add_argument("--output-dir", type=Path, default=OUTPUT_ROOT)
    args = parser.parse_args(argv)
    set_nature_style(font_size=8)
    n = len(args.files)
    fig, axes = plt.subplots(n, 1, figsize=(7.0, 2.2 * n))
    axes = np.atleast_1d(axes)
    for ax, path in zip(axes, args.files):
        record = load_pt(path)
        ts = np.asarray(record["ts_dynamic"], float).ravel()
        ys = np.asarray(record["ys_dynamic"], np.float32)
        if ys.ndim == 1:
            ys = ys[:, None]
        for d, label in enumerate(channel_labels(record)[: ys.shape[1]]):
            ax.plot(ts, ys[:, d], linewidth=0.9, label=label)
        tx = transition_x(record)
        if tx is not None:
            ax.axvline(tx, color="black", linestyle="--", linewidth=1.0)
        ax.set_title(Path(path).stem, fontsize=8)
        ax.legend(fontsize=7)
    out = ensure_output(args.output_dir)
    png = out / "bury_real_transition_points.png"
    fig.tight_layout()
    fig.savefig(png, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
