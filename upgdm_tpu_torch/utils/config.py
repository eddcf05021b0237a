"""YAML grid configs: every leaf is a list; the grid is the cartesian product.

Counterpart of ``upgdm_tpu/utils/config.py`` (reference
utils/utils.py:87-119): ``grid_parameters_generative_learning`` and the
Hp_grid summary of the swept axes. The spdata variant, with its nested gnn
sub-grids, waits for the graph families.
"""
from __future__ import annotations

import copy
import itertools as it
from typing import Dict, List, Tuple

import yaml

__all__ = ["load_grid_config", "grid_parameters_generative_learning"]


def load_grid_config(path) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _hp_grid_summary(sections: Dict[str, dict]) -> dict:
    out = {}
    for key, params in sections.items():
        swept = {}
        for name, values in params.items():
            if not isinstance(values, list):
                raise ValueError(f"Error param_values type:{type(values)}")
            if len(values) > 1:
                swept[name] = values
        if swept:
            out[key] = swept
    return out


def _product(params: dict):
    for values in it.product(*params.values()):
        yield dict(zip(params.keys(), values))


def grid_parameters_generative_learning(
    train_params, net_params, loss_params, optimizer_params, **_
) -> Tuple[List[tuple], dict]:
    """Flat product over all four sections (utils/utils.py:87-119)."""
    hp_grid = _hp_grid_summary(
        {"net": net_params, "train": train_params, "loss": loss_params,
         "optimizer": optimizer_params}
    )
    out = []
    for tp in _product(train_params):
        for np_ in _product(net_params):
            for lp in _product(loss_params):
                for op in _product(optimizer_params):
                    out.append(
                        (copy.deepcopy(tp), copy.deepcopy(np_), copy.deepcopy(lp),
                         copy.deepcopy(op))
                    )
    return out, hp_grid
