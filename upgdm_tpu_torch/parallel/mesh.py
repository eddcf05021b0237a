"""Process groups and ranks.

Counterpart of ``upgdm_tpu/parallel/mesh.py``. The JAX package runs one
program over a mesh of devices; the port runs one process per device in a
``torch.distributed`` group: NCCL between cards, gloo on the CPU.

  - ``maybe_init_distributed`` starts the group once per process (a no-op in
    a single process), as ``jax.distributed.initialize`` does;
  - ``make_mesh`` describes the calling rank: the world size, its rank, the
    device its collectives run on, the group (one rank with no group);
  - ``dp_sharding`` gives the rank's rows of a global batch and
    ``replicated`` the identity, the two shardings the JAX package uses;
  - ``spawn_ranks`` runs a function in a fresh group of N processes with a
    deadline (the dry run, the tests, the smoke run's two-rank check).

Nothing falls back quietly: a world size larger than the visible cards, a
backend that fails to start and a rank that fails all raise.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "dp_sharding",
    "replicated",
    "maybe_init_distributed",
    "spawn_ranks",
]

_DISTRIBUTED_INITIALIZED = False


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def maybe_init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, *, device=None,
                           backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> bool:
    """Start this process's ``torch.distributed`` group, opt-in.

    Any explicit argument opts in, and so do torchrun's variables
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, folded into
    the arguments as the JAX package folds its ``JAX_*`` names); without
    either it is a no-op and returns False. ``init_process_group`` runs
    exactly once: a second call returns False. The backend is NCCL when the
    ranks' ``device`` (default the card) is CUDA and gloo on the CPU, unless
    ``backend`` names one (gloo between processes on one card: NCCL refuses
    two ranks on one GPU). With NCCL the rank takes card ``LOCAL_RANK``
    (default its rank), and more ranks on this host than visible cards
    raise. Returns True when the group was started."""
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED or dist.is_initialized():
        return False
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if all(a is None for a in (init_method, world_size, rank)):
        return False  # single-process run: nothing to do
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        local = _env_int("LOCAL_RANK")
        local = local if local is not None else (rank or 0)
        per_host = _env_int("LOCAL_WORLD_SIZE") or world_size or 1
        if per_host > cards or local >= cards:
            raise RuntimeError(f"{per_host} NCCL ranks on a host with {cards} visible cards "
                               f"(local rank {local}): one rank per card")
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    _DISTRIBUTED_INITIALIZED = True
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The calling rank of a data-parallel group. ``device`` is where the
    group's collectives run: the rank's card under NCCL, the CPU under gloo.
    ``group`` is None for the one-rank mesh of a process with no group."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, on ``x``'s device: a SUM divided
        by the world size (gloo has no AVG)."""
        if self.group is None:
            return x
        buf = x.to(self.device)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return (buf / self.world_size).to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on axis 0 in rank order, on the
        collectives' device (every rank's ``x`` has one shape)."""
        if self.group is None:
            return x
        buf = x.to(self.device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The calling rank's mesh: the whole process group, or one rank when
    there is none. ``n_devices`` other than the group's size raises (a
    process cannot reach another's device)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} devices needs one process per device: "
                               "launch the ranks with torchrun (maybe_init_distributed)")
        return Mesh(1, 0, torch.device("cpu"))
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise RuntimeError(f"a mesh of {n_devices} devices in a group of {world} ranks")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(world, dist.get_rank(), device, dist.group.WORLD)


def dp_sharding(mesh: Mesh, n: int) -> slice:
    """The rank's rows of a global batch of ``n`` rows: the batch axis split
    in equal consecutive parts, rank order (``n`` a multiple of the world
    size)."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} rows over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh, x):
    """Every rank holds all of ``x``."""
    return x


def _rank_main(rank, fn, world_size, store, backend, device, out_dir, timeout_s, args):
    maybe_init_distributed(f"file://{store}", world_size, rank, device=device, backend=backend,
                           timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *, backend: str = "gloo",
                device: str = "cpu", deadline_s: float = 120.0,
                timeout_s: float = 60.0) -> list:
    """``[fn(rank, *args) for each rank]``, each run in a fresh process of
    one group of ``world_size`` ranks (spawned; ``fn`` and its results
    picklable, ``fn`` importable). The group meets at a file store, not a
    port. A rank that raises makes the call raise, and the others are
    killed; past ``deadline_s`` seconds every rank is killed and the call
    raises ``TimeoutError``. A collective waits at most ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="upgdm_ranks_") as tmp:
        store = Path(tmp) / "store"
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, str(store), backend, device, tmp, timeout_s,
                              tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.0, end - time.monotonic())):
                if time.monotonic() >= end:
                    raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                                       f"still running after {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
