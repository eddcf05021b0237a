"""Profiling and phase-timing hooks.

Counterpart of ``upgdm_tpu/utils/profiling.py``:

  - ``PhaseTimer`` / ``phase_timer``: accumulated wall-clock time of named
    phases with a report table (the JAX package's), the store of the
    program's spans and counters besides;
  - ``annotate``: the program's span, a context manager and a decorator.
    With no profiler recording it costs one check, and inside the capture
    of a CUDA graph it records nothing. Under a profiler (the
    benchmark's traced window, or ``trace``) it opens a
    ``torch.profiler.record_function`` range, so the span sits in the
    Chrome trace on the kernels' clock, and adds to the global timer its
    calls, host seconds, host self seconds (less the spans opened inside it)
    and, with CUDA initialised, the seconds between a pair of CUDA events
    on the current stream;
  - ``count`` / ``counters``: always-on named counts;
  - ``trace``: a ``torch.profiler`` scope over the CPU and, where there is a
    card, CUDA activity, written as a Chrome trace into ``log_dir`` with the
    timer's span totals and counters beside it (``phases.json``);
  - ``device_memory_stats``: ``torch.cuda.memory_stats`` of a CUDA device,
    ``None`` for the CPU (as the JAX package returns ``None`` for a device
    without statistics).

Spans are recorded from the thread that drives the device; a span open on
one thread and another thread's span are not told apart.
"""
from __future__ import annotations

import contextlib
import functools
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["PhaseTimer", "phase_timer", "trace", "annotate", "count", "counters",
           "device_memory_stats"]

_profiling = torch.autograd._profiler_enabled


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class PhaseTimer:
    """Accumulating named-phase wall-clock timer; also the store of the
    spans of ``annotate`` (``spans()``) and of ``count`` (``counters``)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self._self_s: Dict[str, float] = defaultdict(float)
        self._stream_s: Dict[str, float] = {}
        self._events = []  # (name, start, end) CUDA events not yet read
        self._open = []  # [span, record_function, start event, t0, child seconds]

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def reset(self):
        """Forget every phase, span and counter."""
        self.__init__()

    def spans(self) -> Dict[str, dict]:
        """By span name: ``calls``, ``host_s``, ``self_s`` and ``stream_s``
        (``None`` for a span recorded without CUDA events). Waits for the
        events still in flight."""
        for name, a, b in self._events:
            b.synchronize()
            self._stream_s[name] = self._stream_s.get(name, 0.0) + a.elapsed_time(b) * 1e-3
        self._events.clear()
        return {n: {"calls": self.counts[n], "host_s": self.totals[n], "self_s": s,
                    "stream_s": self._stream_s.get(n)} for n, s in self._self_s.items()}

    def _enter(self, span):
        rf = torch.profiler.record_function(span.name)
        rf.__enter__()
        start = _stream_event()
        self._open.append([span, rf, start, time.perf_counter(), 0.0])

    def _exit(self):
        span, rf, start, t0, child = self._open.pop()
        end = _stream_event() if start is not None else None
        dt = time.perf_counter() - t0
        rf.__exit__(None, None, None)
        name = span.name
        self.totals[name] += dt
        self.counts[name] += 1
        self._self_s[name] += dt - child
        if self._open:
            self._open[-1][4] += dt
        if start is not None:
            self._events.append((name, start, end))

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


def _stream_event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """One named span, shared by every use of the name: entering it with no
    profiler recording checks once and keeps nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling() and not _capturing():  # a capture runs nothing to time
            _GLOBAL_TIMER._enter(self)
        return self

    def __exit__(self, *exc):
        opened = _GLOBAL_TIMER._open
        if opened and opened[-1][0] is self:
            _GLOBAL_TIMER._exit()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_SPANS: Dict[str, _Span] = {}


def annotate(name: str) -> _Span:
    """The span ``name``: ``with annotate(name): ...`` or ``@annotate(name)``.
    Recorded only while a profiler records (see the module's docstring)."""
    span = _SPANS.get(name)
    if span is None:
        span = _SPANS[name] = _Span(name)
    return span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    _GLOBAL_TIMER.counters[name] += n


def counters() -> Dict[str, int]:
    """The counters of ``count``, by name."""
    return dict(_GLOBAL_TIMER.counters)


@contextlib.contextmanager
def trace(log_dir: str = "upgdm_trace"):
    """torch.profiler scope; on exit its Chrome trace is written to
    ``<log_dir>/trace.json`` (open in Perfetto or chrome://tracing) and the
    global timer's span totals and counters to ``<log_dir>/phases.json``.
    Yields the profiler, whose ``key_averages()`` sums the time by
    operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    totals = {"spans": _GLOBAL_TIMER.spans(), "counters": counters()}
    (out / "phases.json").write_text(json.dumps(totals, indent=2))


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
