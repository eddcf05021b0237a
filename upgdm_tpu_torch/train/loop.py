"""Training loop.

Counterpart of ``upgdm_tpu/train/loop.py`` (reference
train/train_diffusion_timeseries.py:17-211):

  - StandardScaler fit on the train split, per-batch transform;
  - stage dispatch (pretrain_f / pretrain_g / NsDiff_model) through the
    model's ``loss_fn(select=...)`` and ``trainable_mask``;
  - batches shuffled by ``np.random.default_rng(seed)``, so the batch order
    is the JAX package's;
  - a NaN loss leaves weights and optimizer state untouched and its batch
    out of the running mean; a NaN at the end of an epoch raises into the
    emergency path;
  - periodic ``ckpt/tmpt_model_{epoch}iter``, final
    ``trained_model/model_trained`` (+ yaml), ``emergency_checkpoint.pth``
    with resume;
  - ``train_trace/record_scores.json`` {epoch[], train_scores[],
    val_scores[]} with the reference's running means n*s/(n+1) + loss/(n+1).

The step runs eagerly with autograd on the model's device. With
``net_param["train_dtype"]="bfloat16"`` (opt-in, as in the JAX package) the
forward and backward run under ``torch.autocast``: the products take bf16
copies of the float32 master weights and of their inputs; the loss, the
gradients, the master weights and Adam stay float32. Graph batches (``adj``)
and data parallelism raise until their slices land.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..models.factory import diffusion_models
from ..utils import io as uio
from .optimizers import make_lr_schedule, make_optimizer

__all__ = ["run_training", "make_train_step"]


def make_train_step(model, optimizer: torch.optim.Optimizer, select: Optional[str],
                    lr_at: Optional[Callable[[int], float]] = None):
    """``step(batch) -> loss`` (a float) for one optimisation step.

    ``lr_at(n)`` gives the learning rate of the update after ``n`` applied
    ones; the count lives in the optimizer's first parameter group
    (``applied_updates``), so it is saved and resumed with its state. A
    NaN loss skips the update and leaves the count."""
    train_dt = str(model.net_param.get("train_dtype", "float32"))
    if train_dt not in ("float32", "bfloat16", "bf16"):
        raise ValueError(f"train_dtype={train_dt!r}: expected 'float32' or 'bfloat16'")
    bf16 = train_dt != "float32"
    group = optimizer.param_groups[0]
    group.setdefault("applied_updates", 0)

    def step(batch) -> float:
        if lr_at is not None:
            lr = lr_at(group["applied_updates"])
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(model.device.type, dtype=torch.bfloat16, enabled=bf16):
            loss = model.loss_fn(batch, select=select, train=True)
        loss = loss.float()
        loss.backward()
        value = loss.item()
        if math.isfinite(value):
            optimizer.step()
            group["applied_updates"] += 1
        return value

    return step


def _batches(n, batch_size, shuffle, rng):
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        yield idx[start : start + batch_size]


def run_training(trainset, validationset, train_param: dict, net_param: dict,
                 loss_param: dict, optimizer_param: dict, records_path, adj=None,
                 seed: int = 0, model=None, dataset_param: Optional[dict] = None, device=None):
    """Train one configuration on stacked windows [num, T, F]; returns
    record_scores. The model is built from ``net_param`` on ``device``
    (default the card) unless one is given."""
    if adj is not None:
        raise NotImplementedError("graph batches (adj) wait for the graph families")
    if train_param.get("dataparallel") or train_param.get("dataparallel_set"):
        raise NotImplementedError("data-parallel training waits for the multi-GPU slice")
    records_path = Path(records_path)
    records_path.mkdir(parents=True, exist_ok=True)
    trainset = np.asarray(trainset, dtype=np.float32)
    validationset = np.asarray(validationset, dtype=np.float32)
    select = train_param.get("train_model_select")
    select_for_loss = None if select == "NsDiff_model" else select

    if model is None:
        model = diffusion_models(task_model=net_param["task_model"], net_param=net_param,
                                 train_model_select=select, seed=seed, device=device)
    if model.scaler == "StandardScaler":
        # per-feature stats over all windows x time: the reference's
        # cat-then-std
        model._scaler.fit(trainset.reshape(-1, trainset.shape[-1]), axis=0)

    steps_per_epoch = max(1, int(np.ceil(trainset.shape[0] / train_param["train_batch_size"])))
    epoch_sched = make_lr_schedule(optimizer_param)
    mask = model.trainable_mask(select if select not in (None, "NsDiff_model") else None)
    optimizer = make_optimizer(optimizer_param, model.net, mask)

    # emergency resume (utils/utils.py:641-658)
    init_epoch, record_scores, em_sd, em_opt = uio.load_emergency_checkpoint(records_path)
    if em_sd is not None:
        model.load_state_dict(em_sd)
        if em_opt is not None:
            optimizer.load_state_dict(em_opt)
        else:
            print(f"resuming at epoch {init_epoch} from an emergency checkpoint with no torch "
                  "optimizer state: fresh optimizer moments")
    train_step = make_train_step(
        model, optimizer, select_for_loss,
        None if epoch_sched is None else lambda n: epoch_sched(n // steps_per_epoch))

    def batch_of(data, idx):
        batch = data[idx]
        if model.scaler == "StandardScaler":
            batch = model.scaler_transform(batch)
        return torch.as_tensor(np.asarray(batch, np.float32), device=model.device)

    np_rng = np.random.default_rng(seed)
    current_step = init_epoch
    try:
        for epoch in range(init_epoch, train_param["train_epochs"]):
            train_score, n, loss = 0.0, 0, 0.0
            for idx in _batches(trainset.shape[0], train_param["train_batch_size"], True, np_rng):
                loss = train_step(batch_of(trainset, idx))
                if np.isnan(loss):
                    continue
                train_score = n * train_score / (n + 1) + loss / (n + 1)
                n += 1
            if np.isnan(loss):
                raise ValueError("loss is None")
            current_step = epoch + 1

            val_score = 0.0
            if train_param.get("test_set"):
                with torch.no_grad():
                    for m_, idx in enumerate(_batches(validationset.shape[0],
                                                      train_param["val_batch_size"], False,
                                                      np_rng)):
                        lv = model.loss_fn(batch_of(validationset, idx), select=select_for_loss,
                                           train=False).item()
                        if np.isnan(lv):
                            raise ValueError("loss is None")
                        val_score = m_ * val_score / (m_ + 1) + lv / (m_ + 1)

            record_scores["epoch"].append(epoch)
            record_scores["train_scores"].append(train_score)
            record_scores["val_scores"].append(val_score)

            if (epoch % train_param.get("ckpt_period", 2) == 0 and epoch != 0
                    and train_param.get("ckpt")):
                uio.save_checkpoint(records_path / "ckpt", f"tmpt_model_{epoch}iter",
                                    model.state_dict(), net_param)
    except KeyboardInterrupt:
        raise
    except Exception as e:  # emergency checkpoint (train_diffusion_spdata.py:155-174)
        print(f"training interrupted: {e}")
        uio.emergency_checkpoint(records_path, model.state_dict(), net_param,
                                 optimizer.state_dict(), current_step, record_scores)
        uio.save_record(records_path / "train_trace/record_scores.json", record_scores)

    # the optimizer changed the weights in place: drop the cast copies that
    # bf16 sampling (fg_sampling_dtype, the CPU denoiser) would otherwise reuse
    model.weights_changed()
    uio.save_checkpoint(records_path / "trained_model", "model_trained", model.state_dict(),
                        net_param)
    # resolved single-value config consumed at inference (model_trained.yaml)
    uio.save_config_yaml(
        records_path / "trained_model/model_trained.yaml",
        {
            "dataset": dataset_param,
            "train": train_param,
            "net": {k: v for k, v in net_param.items() if k != "device"},
            "optimizer": optimizer_param,
            "loss": loss_param,
        },
    )
    uio.save_record(records_path / "train_trace/record_scores.json", record_scores)
    return record_scores
