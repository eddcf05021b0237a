"""Supervised graph-regression training loop.

Counterpart of ``upgdm_tpu/train/vanilla.py``: per-epoch metric registry
(train/val per score metric), MSE/BCE/CE/CEP loss dispatch, the PNA
degree-histogram precompute, the checkpoint and ``record_scores.json``. The
JAX package takes a pure init/apply pair; here the model is an
``nn.Module`` whose ``forward(x, adj[, t])`` is the prediction (or the
energy for CEP), trained in place on ``device`` (default: the card).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..utils import io as uio
from ..utils.device import resolve_device
from .losses import evaluation_score, loss_wrapper, train_loss
from .optimizers import make_lr_schedule, make_optimizer

__all__ = ["run_training_vanilla", "deg_histogram"]


def deg_histogram(adjs: np.ndarray) -> np.ndarray:
    """Degree histogram across a stack of dense adjacencies (PNA precompute)."""
    degrees = np.asarray(adjs).sum(axis=-1).astype(int).ravel()
    return np.bincount(degrees, minlength=int(degrees.max()) + 1 if len(degrees) else 1)


def run_training_vanilla(
    trainset: Dict[str, np.ndarray],
    validationset: Dict[str, np.ndarray],
    train_param: dict,
    net_param: dict,
    loss_param: dict,
    optimizer_param: dict,
    records_path,
    model: nn.Module,
    seed: int = 0,
    device=None,
):
    """Supervised loop over dense graph batches.

    trainset/validationset: {"x": [N, V, F], "adj": [N, V, V], "y": [N]}.
    The batches of an epoch are a permutation from
    ``np.random.default_rng(seed)``, as in the JAX package; CEP's timesteps
    and noise draw from a ``torch.Generator`` seeded with ``seed``.
    """
    device = resolve_device(device)
    records_path = Path(records_path)
    records_path.mkdir(parents=True, exist_ok=True)
    record_scores = {"epoch": []}
    metrics = {}
    for score_metric in train_param.get("score_metrics", ["mse"]):
        metrics[score_metric] = evaluation_score(score_metric)
        record_scores[score_metric] = {"train_scores": [], "val_scores": []}

    criterion = train_loss(loss_param["loss_metric"], loss_param)
    is_cep = loss_param["loss_metric"] == "CEPLoss"
    generator = torch.Generator(device=device).manual_seed(seed)
    model = model.to(device)
    optimizer = make_optimizer(optimizer_param, nn.ModuleDict({"model": model}))
    schedule = make_lr_schedule(optimizer_param)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    def loss_fn(x, adj, y):
        if is_cep:
            return loss_wrapper("CEPLoss", criterion, (x, y),
                                model_fn=lambda nx, t: model(nx, adj, t), generator=generator)
        pred = model(x, adj).squeeze()
        return loss_wrapper(loss_param["loss_metric"], criterion, pred, y)

    @torch.no_grad()
    def predict(data):
        return model(tensor(data["x"]), tensor(data["adj"])).squeeze().cpu().numpy()

    bs = train_param.get("batch_size", 32)
    rng = np.random.default_rng(seed)
    n = trainset["x"].shape[0]
    step = 0
    for epoch in range(train_param["train_epochs"]):
        idx = rng.permutation(n)
        losses = []
        model.train()
        for start in range(0, n, bs):
            sel = idx[start : start + bs]
            if schedule is not None:
                for group in optimizer.param_groups:
                    group["lr"] = schedule(step)
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(tensor(trainset["x"][sel]), tensor(trainset["adj"][sel]),
                           tensor(trainset["y"][sel]))
            loss.backward()
            optimizer.step()
            step += 1
            losses.append(float(loss.detach()))
        model.eval()
        record_scores["epoch"].append(epoch)
        for score_metric, fn in metrics.items():
            if fn is None or is_cep:
                tr = va = float(np.mean(losses))
            else:
                tr = float(fn(predict(trainset), trainset["y"]))
                va = float(fn(predict(validationset), validationset["y"]))
            record_scores[score_metric]["train_scores"].append(tr)
            record_scores[score_metric]["val_scores"].append(va)

    uio.save_record(records_path / "record_scores.json", record_scores)
    flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    uio.save_checkpoint(records_path, "model_trained", flat, net_param)
    return record_scores
