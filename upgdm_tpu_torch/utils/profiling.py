"""Profiling and phase-timing hooks.

Counterpart of ``upgdm_tpu/utils/profiling.py``:

  - ``PhaseTimer`` / ``phase_timer``: accumulated wall-clock time of named
    phases with a report table (the JAX package's, unchanged);
  - ``trace``: a ``torch.profiler`` scope over the CPU and, where there is a
    card, CUDA activity, written as a Chrome trace into ``log_dir``;
  - ``annotate``: a named ``torch.profiler.record_function`` range, visible
    inside such traces;
  - ``device_memory_stats``: ``torch.cuda.memory_stats`` of a CUDA device,
    ``None`` for the CPU (as the JAX package returns ``None`` for a device
    without statistics).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["PhaseTimer", "phase_timer", "trace", "annotate", "device_memory_stats"]


class PhaseTimer:
    """Accumulating named-phase wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                          total_s   calls   mean_ms"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30} {total:8.3f} {n:7d} {1000*total/max(n,1):9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {"total_s": t, "calls": self.counts[name]}
            for name, t in self.totals.items()
        }

    def save(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.as_dict(), indent=2))


_GLOBAL_TIMER = PhaseTimer()


def phase_timer() -> PhaseTimer:
    return _GLOBAL_TIMER


@contextlib.contextmanager
def trace(log_dir: str = "upgdm_trace"):
    """torch.profiler scope; on exit its Chrome trace is written to
    ``<log_dir>/trace.json`` (open in Perfetto or chrome://tracing). Yields
    the profiler, whose ``key_averages()`` sums the time by operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current CUDA
    device where there is a card), or ``None`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return dict(torch.cuda.memory_stats(device))
