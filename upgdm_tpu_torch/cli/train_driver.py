"""Experiment orchestration of the training CLI.

Counterpart of ``upgdm_tpu/cli/train_driver.py`` (reference
main_SSLtrain_diffusion_timeseries.py and main_SSLtrain_diffusion_spdata.py):
grid search over YAML list-configs (the spdata grid with its gnn sub-grids),
per-config seeded runs with the save_config dedup (already-trained configs
return their saved scores), hold_out / cross_val evaluation, best-config
selection on min(train + val), and the
HP_analysis_result/<records>/<dataset>/hyperparameters.yaml summary. Every
run trains on ``device`` (default the card). A graph dataset comes with its
``adj_bundle`` (adjs [G, V, V], graph_ids [num]); each split hands
``run_training`` the ids of its windows. ``parallel_grid_search`` runs
each configuration in its own spawned process, spread over the visible
cards.
"""
from __future__ import annotations

import itertools as it
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import yaml

from ..train.loop import run_training
from ..utils.config import (
    grid_parameters_generative_learning,
    grid_parameters_generative_learning_spdata,
)
from ..utils.device import resolve_device
from ..utils.io import save_config_dedup, save_record

__all__ = ["hold_out_score", "cross_val_score", "grid_search", "parallel_grid_search",
           "main_from_args"]


def _split_train_val(n: int, train_size: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_train = int(n * train_size)
    return idx[:n_train], idx[n_train:]


def _split_adj(adj_bundle, tr_idx, va_idx):
    """run_training's ``adj`` of a split: (adjs, train ids, val ids), or None
    for a flat dataset."""
    if adj_bundle is None:
        return None
    adjs, gids = adj_bundle
    return (adjs, gids[tr_idx], gids[va_idx])


def hold_out_score(dataset, train_param, net_param, loss_param, optimizer_param, records_path,
                   configs_counts=0, adj_bundle=None, dataset_param=None, seed=0, device=None):
    """Hold-out evaluation (main_SSLtrain_diffusion_spdata.py:36-67)."""
    save_data_path = Path(records_path) / "hold_out"
    save_data_path.mkdir(parents=True, exist_ok=True)
    tr_idx, va_idx = _split_train_val(dataset.shape[0], train_param["traindata_size"], seed)
    return run_training(
        dataset[tr_idx], dataset[va_idx], train_param, net_param, loss_param, optimizer_param,
        save_data_path, adj=_split_adj(adj_bundle, tr_idx, va_idx), seed=seed,
        dataset_param=dataset_param, device=device,
    )


def cross_val_score(dataset, train_param, net_param, loss_param, optimizer_param, records_path,
                    configs_counts=0, adj_bundle=None, dataset_param=None, seed=0, device=None):
    """K-fold evaluation with running-average scores
    (main_SSLtrain_diffusion_spdata.py:71-130)."""
    path = Path(records_path) / "cross_val"
    path.mkdir(parents=True, exist_ok=True)
    n_splits = train_param.get("n_splits", 5)
    idx = np.random.default_rng(seed).permutation(dataset.shape[0])
    folds = np.array_split(idx, n_splits)
    average = {"epoch": [], "train_scores": None, "val_scores": None}
    for k in range(n_splits):
        val_idx = folds[k]
        tr_idx = np.concatenate([folds[j] for j in range(n_splits) if j != k])
        rs = run_training(
            dataset[tr_idx], dataset[val_idx], train_param, net_param, loss_param,
            optimizer_param, path / f"random_{k}", adj=_split_adj(adj_bundle, tr_idx, val_idx),
            seed=seed + k, dataset_param=dataset_param, device=device,
        )
        ts, vs = np.asarray(rs["train_scores"]), np.asarray(rs["val_scores"])
        if average["train_scores"] is None:
            average.update(epoch=rs["epoch"], train_scores=ts, val_scores=vs)
        else:
            m = min(len(ts), len(average["train_scores"]))
            average["train_scores"] = (ts[:m] + k * average["train_scores"][:m]) / (k + 1)
            average["val_scores"] = (vs[:m] + k * average["val_scores"][:m]) / (k + 1)
    average["train_scores"] = np.asarray(average["train_scores"]).tolist()
    average["val_scores"] = np.asarray(average["val_scores"]).tolist()
    save_record(path / "average_scores.json", average)
    return average


def _select_best(configs_record_scores: dict):
    """Best config on min(train+val) (main_SSLtrain_diffusion_spdata.py:210-231)."""
    stats, best = {}, (None, None)
    for name, rs in configs_record_scores.items():
        if not rs.get("val_scores"):
            continue
        total = [v + t for v, t in zip(rs["val_scores"], rs["train_scores"])]
        i = int(np.argmin(total))
        stats[name] = rs["val_scores"][i]
        if best[1] is None or rs["val_scores"][i] < best[1]:
            best = (name, rs["val_scores"][i])
    return stats, best


def _set_data_shape(net_param: dict, dataset_param: dict, nf: int) -> None:
    if "NsDiff" in net_param["task_model"] or net_param["task_model"] in ("TMDM", "DiffusionTS"):
        net_param.update(windows=dataset_param["windows"], pred_len=dataset_param["pred_len"],
                         dataset_nf=nf)
    elif "DiffSTG" in net_param["task_model"]:
        net_param.update(T_h=dataset_param["windows"], T_p=dataset_param["pred_len"], F=nf)
    else:
        raise ValueError("the definition of task_model don't exit")


def grid_search(dataset_params: dict, train_params: dict, net_params: dict, loss_params: dict,
                optimizer_params: dict, records_path, build_dataset: Callable[[dict], tuple],
                spdata: bool = False, hp_analysis_root: str = "HP_analysis_result", device=None):
    """Full grid driver (main_SSLtrain_diffusion_spdata.py:132-236).

    build_dataset(dataset_param) -> (dataset_array, adj_bundle_or_None,
    feature_count).
    """
    expand = (grid_parameters_generative_learning_spdata if spdata
              else grid_parameters_generative_learning)
    records_path = Path(records_path)
    hparams_path = Path(hp_analysis_root) / records_path.name
    hparams_path.mkdir(parents=True, exist_ok=True)

    for values in it.product(*dataset_params.values()):
        dataset_param = dict(zip(dataset_params.keys(), values))
        dataset, adj_bundle, nf = build_dataset(dataset_param)
        parameters_list, hp_grid = expand(train_params, net_params, loss_params,
                                          optimizer_params)
        rel = "dataset_{}_w{}p{}st{}".format(
            str(dataset_param.get("filter", "*")).replace("*", ""),
            dataset_param["windows"], dataset_param["pred_len"], dataset_param["sampling_t"],
        )
        (hparams_path / rel).mkdir(parents=True, exist_ok=True)
        with open(hparams_path / rel / "hyperparameters.yaml", "w") as f:
            yaml.dump(hp_grid, f)

        grid_search_path = records_path / rel / "grid_search"
        grid_search_path.mkdir(parents=True, exist_ok=True)
        configs_record_scores = {}
        for configs_count, (train_param, net_param, loss_param, optimizer_param) in enumerate(
            parameters_list
        ):
            save_config_path = grid_search_path / f"config_{configs_count}"
            save_config_path.mkdir(parents=True, exist_ok=True)
            _set_data_shape(net_param, dataset_param, nf)
            not_trained, record_scores = save_config_dedup(
                save_config_path, f"config_{configs_count}.yaml",
                dataset_param=dataset_param, net_param=net_param, train_param=train_param,
                optimizer_param=optimizer_param, loss_param=loss_param,
            )
            if not_trained:
                eval_fn = (hold_out_score if train_param["model_evaluation"] == "hold_out"
                           else cross_val_score)
                record_scores = eval_fn(
                    dataset, train_param, net_param, loss_param, optimizer_param,
                    save_config_path, configs_counts=configs_count, adj_bundle=adj_bundle,
                    dataset_param=dataset_param, seed=configs_count, device=device,
                )
            configs_record_scores[f"config_{configs_count}"] = record_scores

        save_record(grid_search_path / "configs_record_scores.json", configs_record_scores)
        stats, (best_name, best_val) = _select_best(configs_record_scores)
        print(f"best config: {best_name} val_loss={best_val}")
        save_record(grid_search_path / "all_models_record_statistic.json", stats)


def parallel_grid_search(dataset_params, train_params, net_params, loss_params, optimizer_params,
                         records_path, build_dataset: Callable, spdata: bool = False,
                         processes: int = 2, device=None):
    """Process-parallel grid search (``upgdm_tpu/cli/train_driver.py:195-245``;
    main_SSLtrain_diffusion_spdata.py:263-336, disabled at the reference's
    call site: the sequential ``grid_search`` stays the default).

    Each configuration is one ``hold_out_score`` with ``seed=configs_count``
    in a process of a spawn-context pool, its records under
    ``records_path/grid_search/config_<i>``, with no dedup and no summary, as
    in the JAX package. Configuration i trains on ``cuda:(i % cards)``, or on
    the CPU with ``device="cpu"``. ``build_dataset`` must be picklable.
    Returns {``config_<i>``: record_scores}."""
    import multiprocessing as mp

    expand = (grid_parameters_generative_learning_spdata if spdata
              else grid_parameters_generative_learning)
    jobs = []
    for values in it.product(*dataset_params.values()):
        dataset_param = dict(zip(dataset_params.keys(), values))
        parameters_list, _ = expand(train_params, net_params, loss_params, optimizer_params)
        jobs.extend((dataset_param, cfg, i) for i, cfg in enumerate(parameters_list))
    if resolve_device(device).type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{i % cards}" for _, _, i in jobs]
    else:
        devices = ["cpu"] * len(jobs)
    with mp.get_context("spawn").Pool(processes=processes) as pool:
        results = pool.starmap(
            _parallel_one_config,
            [(records_path, dataset_param, cfg, i, build_dataset, spdata, dev)
             for (dataset_param, cfg, i), dev in zip(jobs, devices)])
    return dict(results)


def _parallel_one_config(records_path, dataset_param, cfg, configs_count, build_dataset, spdata,
                         device):
    train_param, net_param, loss_param, optimizer_param = cfg
    dataset, adj_bundle, nf = build_dataset(dataset_param)
    _set_data_shape(net_param, dataset_param, nf)
    save_config_path = Path(records_path) / "grid_search" / f"config_{configs_count}"
    save_config_path.mkdir(parents=True, exist_ok=True)
    rs = hold_out_score(dataset, train_param, net_param, loss_param, optimizer_param,
                        save_config_path, configs_counts=configs_count, adj_bundle=adj_bundle,
                        dataset_param=dataset_param, seed=configs_count, device=device)
    return f"config_{configs_count}", rs


def main_from_args(args, build_dataset: Callable, spdata: bool, device=None):
    """Run ``args.train_mode`` (grid, hold_out, cross_val) on ``args.cfg``."""
    with open(args.cfg, "r") as f:
        cfg = yaml.safe_load(f)
    records_path = Path(cfg["out_dir"])
    records_path.mkdir(parents=True, exist_ok=True)

    if args.train_mode == "grid":
        for _ in range(args.repeat):
            grid_search(cfg["dataset"], cfg["train"], cfg["net"], cfg["loss"], cfg["optimizer"],
                        records_path, build_dataset, spdata=spdata, device=device)
        return
    # single-config modes take the FIRST value of every list
    single = {
        sec: {k: (v[0] if isinstance(v, list) else v) for k, v in cfg[sec].items()}
        for sec in ("dataset", "train", "net", "loss", "optimizer")
    }
    dataset, adj_bundle, nf = build_dataset(single["dataset"])
    net_param = single["net"]
    _set_data_shape(net_param, single["dataset"], nf)
    eval_fn = hold_out_score if args.train_mode == "hold_out" else cross_val_score
    eval_fn(dataset, single["train"], net_param, single["loss"], single["optimizer"],
            records_path, adj_bundle=adj_bundle, dataset_param=single["dataset"], device=device)
