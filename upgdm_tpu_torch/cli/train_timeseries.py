"""CLI: train diffusion models on flat time-series SDE datasets.

Counterpart of ``upgdm_tpu/cli/train_timeseries.py`` (reference
main_SSLtrain_diffusion_timeseries.py):

    python -m upgdm_tpu_torch.cli.train_timeseries --cfg <yaml> \
        --train_mode grid|hold_out|cross_val --repeat N [--real] [--device cpu]

Trains on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from ..utils.data_prep import pre_dataset_timeseries, pre_dataset_timeseries_real
from .train_driver import main_from_args


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="modelGym")
    parser.add_argument("--cfg", default="configs/grid_search/diffusion_model_NsDiff.yaml",
                        type=str, help="The configuration file path.")
    parser.add_argument("--train_mode", default="grid", type=str,
                        help=" train mode: grid,hold_out,cross_val")
    parser.add_argument("--repeat", type=int, default=1, help="The number of repeated jobs.")
    parser.add_argument("--real", action="store_true",
                        help="use the real-data loader (pre_DataSet_Timeseries_real)")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    loader = pre_dataset_timeseries_real if args.real else pre_dataset_timeseries

    def build_dataset(dataset_param: dict):
        x = loader(**dataset_param)
        return x, None, x.shape[-1]

    main_from_args(args, build_dataset, spdata=False, device=args.device)


if __name__ == "__main__":
    main()
