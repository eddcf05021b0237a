"""The rule for random draws under data parallelism.

The JAX package's data-parallel step and sharded sweeps are one SPMD program
over one key, so they draw the same numbers whatever the mesh. The port runs
one process per device, each with its own ``torch.Generator``, all seeded
alike. Inside ``row_shard(lo, hi, total)`` every draw whose shape carries
the batch draws at the global batch size, ``total`` rows, and keeps the
rank's rows ``lo:hi`` on that axis. Each rank thus draws what one process
would draw for the same rows, and its generator moves on exactly as that
process's does: the N-rank run samples the noise, timesteps and dropout
masks of the 1-process run. Each rank draws world-size times the numbers.

Outside the context a draw is the plain ``torch`` call, bit for bit.

A batch axis may hold ``k`` entries per batch row, batch-major (a graph
model's ``B * V`` rows): the global draw then has ``total * k`` entries
there and the rank keeps ``lo * k : hi * k``. Sample-major layouts
(``S * B`` rows) say so through their shape, ``(S, B, ...)`` with the batch
on axis 1.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch

__all__ = ["row_shard", "draw", "keep_rows", "randn", "rand", "randint"]

_SHARD: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "upgdm_row_shard", default=None)


@contextlib.contextmanager
def row_shard(lo: int, hi: int, total: int):
    """Draws inside come from the global batch of ``total`` rows, cut to
    rows ``lo:hi``."""
    if not 0 <= lo < hi <= total:
        raise ValueError(f"row shard [{lo}, {hi}) of {total} rows")
    token = _SHARD.set((int(lo), int(hi), int(total)))
    try:
        yield
    finally:
        _SHARD.reset(token)


def _cut(size: int, where: str):
    """(global size, start, length) of an axis of ``size`` local entries."""
    lo, hi, total = _SHARD.get()
    k, rem = divmod(size, hi - lo)
    if rem or k == 0:
        raise ValueError(f"{where}: axis of {size} entries under a row shard of "
                         f"{hi - lo} rows")
    return total * k, lo * k, (hi - lo) * k


def draw(fn: Callable[[tuple], torch.Tensor], shape: Sequence[int],
         batch_axis: int = 0) -> torch.Tensor:
    """``fn(shape)``, or under a row shard ``fn`` of the global shape cut to
    the rank's rows on ``batch_axis``."""
    shape = tuple(int(s) for s in shape)
    if _SHARD.get() is None:
        return fn(shape)
    size, start, length = _cut(shape[batch_axis], f"draw of shape {shape}")
    full = shape[:batch_axis] + (size,) + shape[batch_axis + 1:]
    return fn(full).narrow(batch_axis, start, length)


def keep_rows(x, batch_axis: int = 0):
    """A given global tensor (a test seam's draws) cut to the rank's rows;
    outside a row shard ``x`` itself."""
    if _SHARD.get() is None:
        return x
    lo, hi, total = _SHARD.get()
    if x.shape[batch_axis] % total:
        raise ValueError(f"seam of shape {tuple(x.shape)} under a row shard of {total} rows")
    k = x.shape[batch_axis] // total
    return x.narrow(batch_axis, lo * k, (hi - lo) * k)


def randn(shape, generator=None, *, dtype=None, device=None, batch_axis: int = 0):
    return draw(lambda s: torch.randn(s, generator=generator, dtype=dtype, device=device),
                shape, batch_axis)


def rand(shape, generator=None, *, dtype=None, device=None, batch_axis: int = 0):
    return draw(lambda s: torch.rand(s, generator=generator, dtype=dtype, device=device),
                shape, batch_axis)


def randint(low: int, high: int, shape, generator=None, *, device=None, batch_axis: int = 0):
    return draw(lambda s: torch.randint(low, high, s, generator=generator, device=device),
                shape, batch_axis)
