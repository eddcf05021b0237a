"""Faults planted in the program under test, to show that the comparison
which decides ``correct`` catches them. A run takes one with ``--fault``
(never in a measured run); the tests drive each through a whole run.

Sweeps:
  ``stale_state``    every call answers with the results of the call before
                     it (the first with those of a call on another input);
  ``half_batch``     each window's MPV and mean taken over half its rows;
  ``altered_answer`` every window reports its MPV 1% high.
Training:
  ``stale_state``    the optimizer's step leaves the weights as they are;
  ``half_batch``     the loss of each step taken over half of its batch.
"""
from __future__ import annotations

import contextlib

__all__ = ["SWEEP", "TRAIN", "sweep_fault", "train_fault"]

SWEEP = ("stale_state", "half_batch", "altered_answer")
TRAIN = ("stale_state", "half_batch")


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _reduce_fault(orig, fault):
    def reduce(outs, std, mean, chunk, node, pred_len):
        mpv, pm = orig(outs, std, mean, chunk, node, pred_len)
        if fault == "altered_answer":
            return mpv * 1.01, pm
        F = outs.shape[2]
        o = outs[:, -pred_len:] * std[None, None, :, None] + mean[None, None, :, None]
        var = o.var(dim=-1, correction=0).reshape(chunk, -1)
        every = o.reshape(chunk, node * pred_len * F, -1)
        half = max(1, var.shape[1] // 2)
        return var[:, :half].mean(dim=1), every[:, :half].mean(dim=(1, 2))
    return reduce


@contextlib.contextmanager
def sweep_fault(fault, uncertainty_module, call):
    """(the call to time) with ``fault`` planted; ``call(i)`` is the sweep."""
    if fault is None:
        yield call
        return
    if fault not in SWEEP:
        raise ValueError(f"unknown sweep fault {fault!r}")
    if fault == "stale_state":
        last = {}

        def stale(i):
            if "out" not in last:
                last["out"] = call(i - 1)
            prev, last["out"] = last["out"], call(i)
            return prev

        yield stale
        return
    U = uncertainty_module
    with _patched(U, "mpv_reduce", _reduce_fault(U.mpv_reduce, fault)):
        yield call


@contextlib.contextmanager
def train_fault(fault, model, optimizer):
    if fault is None:
        yield
        return
    if fault == "stale_state":
        with _patched(optimizer, "step", lambda *a, **k: None):
            yield
        return
    if fault == "half_batch":
        orig = model.loss_fn
        with _patched(model, "loss_fn", lambda batch, **kw: orig(batch[: batch.shape[0] // 2], **kw)):
            yield
        return
    raise ValueError(f"unknown train fault {fault!r}")
