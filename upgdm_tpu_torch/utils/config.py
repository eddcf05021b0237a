"""YAML grid configs: every leaf is a list; the grid is the cartesian product.

Counterpart of ``upgdm_tpu/utils/config.py`` (reference
utils/utils.py:87-179): ``grid_parameters_generative_learning``, its spdata
variant with the nested ``gnn_params`` sub-grids keyed by ``gnn_name``, and
the Hp_grid summary of the swept axes.
"""
from __future__ import annotations

import copy
import itertools as it
from typing import Dict, List, Tuple

import yaml

__all__ = ["load_grid_config", "grid_parameters_generative_learning",
           "grid_parameters_generative_learning_spdata"]


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


def grid_parameters_generative_learning_spdata(
    train_params, net_params, loss_params, optimizer_params, **_
) -> Tuple[List[tuple], dict]:
    """spdata variant with nested gnn sub-grids (utils/utils.py:120-179):
    each ``gnn_name`` sweeps its own ``gnn_params[gnn_name]`` grid into
    ``gnn_param`` (and ``f_gnn_params`` likewise into ``f_gnn_param``)."""
    summary_net = dict(net_params)
    summary_net.pop("gnn_params", None)
    summary_net.pop("f_gnn_params", None)
    hp_grid = _hp_grid_summary(
        {"net": summary_net, "train": train_params, "loss": loss_params,
         "optimizer": optimizer_params}
    )
    net_base = dict(net_params)
    gnn_params = net_base.pop("gnn_params")
    f_gnn_params = net_base.pop("f_gnn_params", None)

    out = []
    for tp in _product(train_params):
        for np_ in _product(net_base):
            for gp in _product(gnn_params[np_["gnn_name"]]):
                np_["gnn_param"] = gp
                f_grids = ([None] if f_gnn_params is None
                           else list(_product(f_gnn_params[np_["f_gnn_name"]])))
                for fgp in f_grids:
                    if fgp is not None:
                        np_["f_gnn_param"] = fgp
                    for lp in _product(loss_params):
                        for op in _product(optimizer_params):
                            out.append(
                                (copy.deepcopy(tp), copy.deepcopy(np_), copy.deepcopy(lp),
                                 copy.deepcopy(op))
                            )
    return out, hp_grid
