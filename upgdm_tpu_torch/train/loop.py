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
loss runs on bf16 copies of every float32 parameter and of the batch and is
cast back to float32 (``cast_loss``, the JAX package's semantics): the
gradients, the master weights and Adam stay float32.

``dataparallel`` / ``dataparallel_set`` train data-parallel across the ranks
of a ``torch.distributed`` group (``parallel/mesh.py``; one rank per card,
launched with ``torchrun``), wired as the JAX package wires its mesh
(``upgdm_tpu/train/loop.py:143-150, 184-187, 235-241``): flat models run
``parallel.data_parallel.make_dp_train_step`` (JAX's step as it is: no
``train_dtype``, no finite guard), graph models with ``adj`` the plain step
on every rank, and each shuffled batch drops its ragged tail to a multiple
of the world size (a batch with nothing left is skipped). Every rank
shuffles with the same seed and validates the whole split; only rank 0
writes, and the others wait for it at a barrier at the end. At world size 1
the flag changes nothing, as in the JAX package, which builds its mesh only
over more than one device; with several visible cards and no group it
raises, since each card needs its own rank.

Graph models (DiffSTG, NsDiff_spatial) train on [num, V, T, F] windows with
``adj``: one adjacency [V, V] for every window, or the mixed-topology tuple
``(adjs [G, V, V], train_graph_ids, val_graph_ids)``, gathered per batch. As
in the JAX package no node mask reaches the loss: the padded nodes of a
mixed-size corpus count in its mean.

A run is deterministic given its seed on the card too, as the JAX package's
is: ``run_training`` holds cuDNN to its deterministic algorithms while it
runs. Without that the weight gradient of the NS-Transformer's circular
token convolution went through an algorithm whose sums land in another
order from run to run, and pretrain_f's scores wandered by a few percent.
"""
from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..models.factory import diffusion_models
from ..utils import io as uio
from ..utils.device import resolve_device
from ..utils.profiling import annotate, count
from .optimizers import make_lr_schedule, make_optimizer

__all__ = ["run_training", "make_train_step", "deterministic_cudnn"]


def make_train_step(model, optimizer: torch.optim.Optimizer, select: Optional[str],
                    lr_at: Optional[Callable[[int], float]] = None):
    """``step(batch) -> loss`` (a float) for one optimisation step.

    ``lr_at(n)`` gives the learning rate of the update after ``n`` applied
    ones; the count lives in the optimizer's first parameter group
    (``applied_updates``), so it is saved and resumed with its state. A
    NaN loss skips the update and leaves the count. Keywords of
    ``step(batch, **kw)`` go to the loss (the ``adj`` of a graph model);
    with bf16 training their float32 tensors are cast too, as the JAX
    package casts every float32 argument of its loss."""
    train_dt = str(model.net_param.get("train_dtype", "float32"))
    if train_dt not in ("float32", "bfloat16", "bf16"):
        raise ValueError(f"train_dtype={train_dt!r}: expected 'float32' or 'bfloat16'")
    bf16 = train_dt != "float32"
    group = optimizer.param_groups[0]
    group.setdefault("applied_updates", 0)

    @annotate("upgdm.train.step")
    def step(batch, **kw) -> float:
        if lr_at is not None:
            lr = lr_at(group["applied_updates"])
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        with annotate("upgdm.train.forward"):
            if bf16:
                kw = {k: v.to(torch.bfloat16) if torch.is_tensor(v) and v.dtype == torch.float32
                      else v for k, v in kw.items()}
                loss = model.cast_loss(batch, torch.bfloat16, select=select, train=True, **kw)
            else:
                loss = model.loss_fn(batch, select=select, train=True, **kw)
        with annotate("upgdm.train.backward"):
            loss.backward()
        with annotate("upgdm.train.sync"):
            value = loss.item()
        count("train.host_syncs")  # every blocking read of the device in the step
        if math.isfinite(value):
            with annotate("upgdm.train.optimizer"):
                optimizer.step()
            group["applied_updates"] += 1
        count("train.steps")
        return value

    return step


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (and no autotuning) inside, the
    process's settings again after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _batches(n, batch_size, shuffle, rng):
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        yield idx[start : start + batch_size]


def run_training(trainset, validationset, train_param: dict, net_param: dict,
                 loss_param: dict, optimizer_param: dict, records_path, adj=None,
                 seed: int = 0, model=None, dataset_param: Optional[dict] = None, device=None):
    """Train one configuration on stacked windows ([num, T, F], or
    [num, V, T, F] for a graph model with ``adj``); returns record_scores.
    The model is built from ``net_param`` on ``device`` (default the card)
    unless one is given. One seed gives the same records on the same device
    (``deterministic_cudnn``)."""
    with deterministic_cudnn():
        return _run_training(trainset, validationset, train_param, net_param, loss_param,
                             optimizer_param, records_path, adj, seed, model, dataset_param,
                             device)


def visible_devices(device) -> int:
    """The devices a data-parallel run on ``device`` would span: every
    visible card for CUDA, one for the CPU."""
    return torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1


def data_parallel_mesh(train_param: dict, device):
    """The mesh a run with ``dataparallel`` trains over, or None: a process
    group of more than one rank. The flag with several visible cards and no
    group raises."""
    if not (train_param.get("dataparallel") or train_param.get("dataparallel_set")):
        return None
    from ..parallel.mesh import make_mesh

    mesh = make_mesh()
    if mesh.group is None and visible_devices(device) > 1:
        raise RuntimeError(
            f"dataparallel over {visible_devices(device)} visible cards needs one process per "
            "card: launch one rank per card with torchrun (python -m torch.distributed.run "
            "--nproc_per_node=<cards> -m upgdm_tpu_torch.cli.train_timeseries ...)")
    return mesh if mesh.world_size > 1 else None


def _run_training(trainset, validationset, train_param, net_param, loss_param,
                  optimizer_param, records_path, adj, seed, model, dataset_param, device):
    dp_mesh = data_parallel_mesh(train_param, model.device if model is not None else device)
    writer = dp_mesh is None or dp_mesh.rank == 0
    records_path = Path(records_path)
    if writer:
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
    lr_at = None if epoch_sched is None else lambda n: epoch_sched(n // steps_per_epoch)
    if dp_mesh is not None and adj is None:
        from ..parallel.data_parallel import make_dp_train_step

        train_step = make_dp_train_step(model, optimizer, dp_mesh, select_for_loss, lr_at=lr_at)
    else:
        train_step = make_train_step(model, optimizer, select_for_loss, lr_at)

    adjs = train_gids = val_gids = None
    if isinstance(adj, tuple):
        adjs, train_gids, val_gids = adj
        adjs = np.asarray(adjs, np.float32)
    elif adj is not None:
        adj = torch.as_tensor(np.asarray(adj, np.float32), device=model.device)

    def graph_of(idx, gids):
        """The loss's graph keywords of a batch: its adjacencies, or none
        for a flat model."""
        if adjs is not None:
            return {"adj": torch.as_tensor(adjs[np.asarray(gids)[idx]], device=model.device)}
        if adj is not None:
            return {"adj": adj.expand(len(idx), *adj.shape)}
        return {}

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
                if dp_mesh is not None:  # the ranks' shards need divisible batches
                    idx = idx[: len(idx) - len(idx) % dp_mesh.world_size]
                    if len(idx) == 0:
                        continue
                loss = train_step(batch_of(trainset, idx), **graph_of(idx, train_gids))
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
                                           train=False, **graph_of(idx, val_gids)).item()
                        if np.isnan(lv):
                            raise ValueError("loss is None")
                        val_score = m_ * val_score / (m_ + 1) + lv / (m_ + 1)

            record_scores["epoch"].append(epoch)
            record_scores["train_scores"].append(train_score)
            record_scores["val_scores"].append(val_score)

            if (epoch % train_param.get("ckpt_period", 2) == 0 and epoch != 0
                    and train_param.get("ckpt") and writer):
                uio.save_checkpoint(records_path / "ckpt", f"tmpt_model_{epoch}iter",
                                    model.state_dict(), net_param)
    except KeyboardInterrupt:
        raise
    except Exception as e:  # emergency checkpoint (train_diffusion_spdata.py:155-174)
        print(f"training interrupted: {e}")
        if writer:
            uio.emergency_checkpoint(records_path, model.state_dict(), net_param,
                                     optimizer.state_dict(), current_step, record_scores)
            uio.save_record(records_path / "train_trace/record_scores.json", record_scores)

    # the optimizer changed the weights in place: drop the cast copies that
    # bf16 sampling (fg_sampling_dtype, the CPU denoiser) would otherwise reuse
    model.weights_changed()
    if writer:
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
    if dp_mesh is not None:
        dp_mesh.barrier()
    return record_scores
