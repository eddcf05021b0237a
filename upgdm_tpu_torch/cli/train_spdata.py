"""CLI: train diffusion models on networked (graph) SDE datasets.

Counterpart of ``upgdm_tpu/cli/train_spdata.py`` (reference
main_SSLtrain_diffusion_spdata.py, argparse contract from
configs/configs_diffusion_spdata.py:4-16):

    python -m upgdm_tpu_torch.cli.train_spdata --cfg <yaml> \
        --train_mode grid|hold_out|cross_val --repeat N [--device cpu]

Trains on the card unless ``--device cpu`` is given; under ``torchrun`` it
joins the ranks' group first (graph models train the plain step on every
rank with ``dataparallel``, as in the JAX package). The graphs of a corpus
are padded to its largest node count; as in the JAX package, the padded
nodes count in the loss.
"""
from __future__ import annotations

import argparse

from ..parallel.mesh import maybe_init_distributed
from ..utils.data_prep import pre_dataset_spdata
from .train_driver import main_from_args


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="modelGym")
    parser.add_argument("--cfg", default="configs/grid_search/diffusion_model_NsDiff_spdata.yaml",
                        type=str, help="The configuration file path.")
    parser.add_argument("--train_mode", default="grid", type=str,
                        help=" train mode: grid,hold_out,cross_val")
    parser.add_argument("--repeat", type=int, default=1, help="The number of repeated jobs.")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def build_dataset(dataset_param: dict):
    """(windows [num, V, L, 1], (adjs, graph_ids), F)."""
    x, adjs, gids = pre_dataset_spdata(**dataset_param)
    return x, (adjs, gids), x.shape[-1]


def main(argv=None):
    args = parse_args(argv)
    maybe_init_distributed(device=args.device)  # a no-op without torchrun
    main_from_args(args, build_dataset, spdata=True, device=args.device)


if __name__ == "__main__":
    main()
