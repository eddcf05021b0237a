"""Paper real-data figure: compose multiple real-data EWS subfigures.

Counterpart of ``upgdm_tpu/figures/real_systems.py``: runs the port's
real-data pipeline (``eval/real_data.py``) for a list of empirical records on
``--device`` (default: the card) and tiles the subfigures into a labelled
grid (matplotlib, imported by the renders; without it the signal tables
are written and nothing is rendered).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..eval import real_data as rda
from .common import OUTPUT_ROOT, ensure_output, skip_render
from .figure_composer import compose_image_grid

DEFAULT_REAL_DATA_NAMES = (
    "bury_2021_anoxia_tsid_3",
    "bury_2021_anoxia_tsid_6",
    "bury_2021_anoxia_tsid_9",
    "bury_2021_thermoacoustic_tsid_1",
    "bury_2021_thermoacoustic_tsid_5",
    "bury_2021_thermoacoustic_tsid_9",
)

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compose real-data EWS subfigures")
    parser.add_argument("--data-real-names", nargs="+", default=list(DEFAULT_REAL_DATA_NAMES))
    parser.add_argument("--output-dir", type=Path, default=OUTPUT_ROOT)
    parser.add_argument("--n-cols", type=int, default=2)
    parser.add_argument("--data-root", default="dataset/real_data")
    parser.add_argument("--real-data-result-root", default="ews_results/real_data")
    parser.add_argument("--bury-prob-root", default="ews_results/bury_2021_ml_probs")
    parser.add_argument("--model-dir", default=None)
    parser.add_argument(
        "--signals", nargs="+",
        default=["model_uncertainty", "model_trend", "ar1", "variance", "bury_ml"],
    )
    parser.add_argument("--device", default=None,
                        help="torch device of the g(x) sweeps (default: the card)")
    ns = parser.parse_args(argv)
    args = rda.default_args(
        data_root=ns.data_root,
        real_data_result_root=ns.real_data_result_root,
        bury_prob_root=ns.bury_prob_root,
        output_root=str(Path(ns.output_dir) / "real_data_subfigs"),
        model_dir=ns.model_dir,
        signals=ns.signals,
        device=ns.device,
    )
    pngs = [rda.run_one(name, args) for name in ns.data_real_names]
    if skip_render():
        return None
    out = ensure_output(ns.output_dir)
    composed = compose_image_grid(pngs, out / "real_systems_figure.png", n_cols=ns.n_cols)
    print(f"saved: {composed}")
    return composed


if __name__ == "__main__":
    main()
