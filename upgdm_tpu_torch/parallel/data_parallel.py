"""Data-parallel training and sharded inference sweeps.

Counterpart of ``upgdm_tpu/parallel/data_parallel.py``. The JAX package
runs one jitted program whose batch carries a 'dp' sharding; the port runs
one process per device, each on its own rows of the global batch, under
``draws.row_shard`` so that it draws what one process draws for those rows.
The model is not wrapped in ``DistributedDataParallel``: the wrappers'
losses call ``self.net[...]`` directly, so DDP's forward hooks would never
fire. The step all-reduces the gradients itself, in one flat buffer.

Every function returns the same thing on every rank. The sweeps shard the
window axis: each rank samples its windows (K1 or K3 on the card, on the
rows it owns) and only the results are gathered.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..eval.uncertainty import _chunks, _double_buffered, mpv_reduce
from . import draws
from .mesh import Mesh, dp_sharding, make_mesh, replicated

__all__ = [
    "make_dp_train_step",
    "dp_train_epoch",
    "sharded_window_ensemble",
    "sharded_fast_mpv_sweep",
]


def make_dp_train_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh,
                       select: Optional[str] = None, with_adj: bool = False,
                       lr_at: Optional[Callable[[int], float]] = None):
    """``step(batch[, adj]) -> loss``: one data-parallel optimisation step on
    the global ``batch`` (every rank passes the same one, its rows a
    multiple of the world size).

    The rank's loss runs on its rows under the row-shard context; after
    ``backward`` the gradients of the optimizer's parameters and the loss
    are all-reduced to their mean in one flat buffer, so every rank applies
    the global batch's gradient and returns the global batch's loss. The
    JAX package's step is kept as it is (``upgdm_tpu/parallel/
    data_parallel.py:33-72``): it calls ``model.loss_fn`` directly, so it
    ignores ``train_dtype``, and it has no finite-loss guard (a NaN loss is
    applied and counted). ``adj`` (``with_adj``) is the shared [V, V]
    adjacency, replicated, or one per row [B, V, V], sharded with the
    batch. ``lr_at`` as in ``train.loop.make_train_step``."""
    group = optimizer.param_groups[0]
    group.setdefault("applied_updates", 0)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, adj=None) -> float:
        if (adj is not None) != with_adj:
            raise TypeError(f"with_adj={with_adj} step called with adj={adj is not None}")
        rows = dp_sharding(mesh, len(batch))
        kw = {}
        if with_adj:
            adj = torch.as_tensor(adj)
            kw["adj"] = replicated(mesh, adj) if adj.ndim == 2 else adj[rows]
        if lr_at is not None:
            lr = lr_at(group["applied_updates"])
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        with draws.row_shard(rows.start, rows.stop, len(batch)):
            loss = model.loss_fn(batch[rows], select=select, train=True, **kw)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        flat = mesh.all_reduce_mean(flat)
        start = 0
        for g in grads:
            g.copy_(flat[start : start + g.numel()].view_as(g))
            start += g.numel()
        optimizer.step()
        group["applied_updates"] += 1
        return flat[-1].item()

    return step


def dp_train_epoch(model, optimizer, mesh: Mesh, data, batch_size: int,
                   select: Optional[str] = None) -> float:
    """One epoch over ``data`` in order, in batches of ``max(batch_size // n
    * n, n)`` rows for n ranks, the ragged tail dropped; the mean loss."""
    step = make_dp_train_step(model, optimizer, mesh, select=select)
    n = mesh.world_size
    bs = max(batch_size // n * n, n)
    losses = [step(data[s : s + bs]) for s in range(0, data.shape[0] - bs + 1, bs)]
    return float(np.mean(losses)) if losses else float("nan")


def _sharded_blocks(model, windows_array, mesh, chunk_windows, noise, reduce):
    """``reduce(outs [rows, O, F, S]) -> tensor [k, ...]`` per block of
    ``n_ranks * chunk_windows`` windows (a ragged block padded with its last
    window), each rank sampling its ``chunk_windows`` windows; yields every
    rank's results gathered in window order, and the block's valid count,
    one block behind the dispatch."""
    node = windows_array.shape[1]
    block = mesh.world_size * chunk_windows
    seams = iter(noise) if noise is not None else None
    out = []

    def dispatch(flat, valid):
        rows = dp_sharding(mesh, block * node)
        with draws.row_shard(rows.start, rows.stop, block * node):
            if seams is None:
                outs, _ = model.evaluation_step(flat[rows])
            else:
                batch_x, _ = model.split_batch(flat[rows])
                outs = model.sample_fn(batch_x, noise=next(seams))
        return [mesh.all_gather(r) for r in reduce(outs)], valid

    def drain(parts, valid):
        out.append(([p.cpu().numpy() for p in parts], valid))

    _double_buffered(dispatch, drain, _chunks(model, windows_array, block))
    return out


def sharded_window_ensemble(model, windows_array: np.ndarray, pred_len: int,
                            mesh: Optional[Mesh] = None, chunk_windows: int = 8,
                            noise: Optional[Sequence] = None) -> List[np.ndarray]:
    """``batched_window_ensemble`` with the window axis sharded over the
    ranks: windows [n, Node, W, F] -> a list of [Node, pred_len, F, S]
    arrays (the cache contract). ``noise`` (test seam): per block, the T
    normals ``sample_chain`` takes for the whole block, [S, n_ranks *
    chunk_windows * Node, O, F]; each rank keeps its rows."""
    mesh = mesh or make_mesh()
    n, node, _, F = windows_array.shape
    if n == 0:
        return []
    block = mesh.world_size * chunk_windows
    out: List[np.ndarray] = []
    # C order, as batched_window_ensemble hands its ensembles back
    tail = lambda outs: [outs[:, -pred_len:, :, :].contiguous()]
    for (ens,), valid in _sharded_blocks(model, windows_array, mesh, chunk_windows, noise, tail):
        ens = ens.reshape(block, node, pred_len, F, ens.shape[-1])
        out.extend(ens[i] for i in range(valid))
    return out


def sharded_fast_mpv_sweep(model, windows_array: np.ndarray, pred_len: int,
                           mesh: Optional[Mesh] = None, chunk_windows: int = 8,
                           noise: Optional[Sequence] = None) -> tuple:
    """``fast_mpv_sweep`` with the window axis sharded over the ranks: each
    rank samples and reduces its own windows (``mpv_reduce``) and only two
    scalars a window are gathered. Returns (mpv [n], pred_mean [n]).
    ``noise`` as in ``sharded_window_ensemble``."""
    mesh = mesh or make_mesh()
    n, node, _, F = windows_array.shape
    if n == 0:
        return np.zeros(0), np.zeros(0)
    dev = model.device
    scaled = model.scaler is not None
    std = torch.as_tensor(model.scaler_std if scaled else np.ones(F), dtype=torch.float32,
                          device=dev)
    mean = torch.as_tensor(model.scaler_mean if scaled else np.zeros(F), dtype=torch.float32,
                           device=dev)
    reduce = lambda outs: mpv_reduce(outs, std, mean, chunk_windows, node, pred_len)
    mpv, pm = [], []
    for (v, m), valid in _sharded_blocks(model, windows_array, mesh, chunk_windows, noise,
                                         reduce):
        mpv.append(v[:valid])
        pm.append(m[:valid])
    return np.concatenate(mpv), np.concatenate(pm)
