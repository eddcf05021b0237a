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

On the CPU the step runs eagerly with autograd. On the card, with
``make_optimizer``'s Adam, it is one CUDA graph a step: the loss, its
backward, a finite guard on the device and the fused update, captured at
the first call and replayed after (``make_train_step``). With
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
import warnings
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
    package casts every float32 argument of its loss.

    Where the optimizer keeps its state and the finite guard on the device
    (``make_optimizer``'s Adam on the card), a non-finite loss turns the
    update into a no-op there, as the JAX package's ``jnp.where`` over
    params and state does, and the step runs as one CUDA graph: its first
    call captures the body (loss, backward, guard, update) for the call's
    input shapes, and each call with those shapes copies its inputs into
    the graph's and replays it (``_StepGraph``). Other shapes run the same
    body eagerly. Any other optimizer steps eagerly after the host has read
    the loss. At the first call on the card no autograd graph over the
    model's parameters may still be alive (the loss of an eager step kept
    by the caller): capture's backward would find their gradient
    accumulators tied to the default stream, and raise."""
    train_dt = str(model.net_param.get("train_dtype", "float32"))
    if train_dt not in ("float32", "bfloat16", "bf16"):
        raise ValueError(f"train_dtype={train_dt!r}: expected 'float32' or 'bfloat16'")
    bf16 = train_dt != "float32"
    group = optimizer.param_groups[0]
    group.setdefault("applied_updates", 0)
    guarded = _guards_on_device(optimizer)

    def body(batch, kw, update=True):
        """The step's work on the device: the loss and its gradients and,
        where the optimizer guards on the device, the guarded update.
        Returns the loss. Looks ``loss_fn``, ``cast_loss`` and ``step`` up
        through their instances at each call."""
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
        loss = loss.detach()
        if guarded and update:
            with annotate("upgdm.train.optimizer"):
                optimizer.found_inf = torch.isfinite(loss).logical_not().float()
                optimizer.step()
        return loss

    graph = _StepGraph(body, model, optimizer) if guarded and _on_card(optimizer) else None

    @annotate("upgdm.train.step")
    def step(batch, **kw) -> float:
        if lr_at is not None:
            lr = lr_at(group["applied_updates"])
            for g in optimizer.param_groups:
                if torch.is_tensor(g["lr"]):
                    g["lr"].fill_(lr)
                else:
                    g["lr"] = lr
        loss = graph(batch, kw) if graph is not None else None
        if loss is None:
            loss = body(batch, kw)
        with annotate("upgdm.train.sync"):
            value = loss.item()
        count("train.host_syncs")  # every blocking read of the device in the step
        if math.isfinite(value):
            if not guarded:
                with annotate("upgdm.train.optimizer"):
                    optimizer.step()
            group["applied_updates"] += 1
        count("train.steps")
        return value

    return step


def _guards_on_device(optimizer) -> bool:
    """Whether ``optimizer`` skips its own update on the device when told
    to (``found_inf``): torch's fused Adam, as ``make_optimizer`` builds it
    on the card."""
    return isinstance(optimizer, torch.optim.Adam) and all(
        g.get("fused") for g in optimizer.param_groups)


def _on_card(optimizer) -> bool:
    """Whether the optimizer's parameters live on a CUDA device, with state
    that a CUDA graph may capture."""
    return all(g.get("capturable") and g["params"][0].is_cuda for g in optimizer.param_groups)


def _signature(batch, kw):
    """What a captured graph holds fixed of a call: the shapes, types and
    devices of its batch and keyword tensors; None where a call cannot be
    replayed (an input that is not a tensor on the card)."""
    items = [("", batch)] + sorted(kw.items())
    if not all(torch.is_tensor(v) and v.is_cuda for _, v in items):
        return None
    return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in items)


def _cuda_graph(warm, run, generator):
    """(replay, out): ``run`` captured as a CUDA graph, with ``generator``'s
    draws in it replayed from the generator's offset at each replay; or
    None where the body synchronises with the host, which a graph cannot
    hold. ``warm()`` runs twice first on a side stream: once for the lazy
    set-up that capture must not see, once more with every synchronising
    CUDA call raising. A capture that fails after that check raises (torch's
    allocator keeps routing the capture's stream to its pool after one)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm()
            holds = True
        except RuntimeError:
            holds = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    if not holds:
        return None
    graph = torch.cuda.CUDAGraph()
    if generator is not None and generator.device.type == "cuda":
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        out = run()
    return graph.replay, out


class _StepGraph:
    """The train step's body as one CUDA graph, captured at the first call
    for that call's input signature and replayed for each call with it.

    Before capture the warm-up (``_cuda_graph``) runs the loss and its
    backward with no update: the lazy set-up, cuBLAS and cuDNN workspaces,
    cached device tables, autograd's own. The optimizer's state is made by a
    step that its device guard skips, so capture finds moments and step
    counts in place. The model's generator is put back where the warm-up
    found it, so the first replay draws what the eager step would. Where
    the body synchronises with the host (a host read or a pageable copy
    inside the loss) the step runs eagerly from then on, counted under
    ``train.graph_fallbacks``."""

    def __init__(self, body, model, optimizer):
        self.body, self.optimizer = body, optimizer
        self.generator = getattr(model, "generator", None)
        self.key = self.replay = self.loss = None
        self.failed = False  # the body synchronises with the host

    def __call__(self, batch, kw):
        """The loss (on the device) of the replayed step, or None where the
        call has to run eagerly."""
        key = _signature(batch, kw)
        if key is None:
            return None
        if self.key is None and not self.failed:
            self._capture(key, batch, kw)
        if key != self.key:
            return None
        self.batch.copy_(batch)
        for k, v in self.kw.items():
            v.copy_(kw[k])
        with annotate("upgdm.train.replay"):
            self.replay()
        count("train.graph_replays")
        return self.loss

    def _capture(self, key, batch, kw):
        opt, gen = self.optimizer, self.generator
        self.batch = batch.clone()
        self.kw = {k: v.clone() for k, v in kw.items()}
        saved = gen.get_state() if gen is not None else None
        device = self.batch.device

        def warm():
            self.body(self.batch, self.kw, update=False)
            opt.found_inf = torch.ones((), device=device)
            opt.step()  # makes the state; the guard leaves everything as it was
            if gen is not None:
                gen.set_state(saved)
            opt.zero_grad(set_to_none=True)

        for g in opt.param_groups:  # the rate the graph reads, written by the step
            if not (torch.is_tensor(g["lr"]) and g["lr"].device == device):
                g["lr"] = torch.tensor(float(g["lr"]), dtype=torch.float32, device=device)
        captured = _cuda_graph(warm, lambda: self.body(self.batch, self.kw), gen)
        if captured is None:
            self.failed = True
            if gen is not None:
                gen.set_state(saved)
            opt.zero_grad(set_to_none=True)
            count("train.graph_fallbacks")
            warnings.warn("the train step runs eagerly: its body synchronises with the host, "
                          "which a CUDA graph cannot hold")
            return
        self.replay, self.loss = captured
        self.key = key
        count("train.graph_captures")


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
