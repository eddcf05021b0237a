"""One ``torch.profiler`` trace of a traced window, read back from its
Chrome-trace export: the device operations (kernels, copies, fills) with
their times, the host span that launched each (the benchmark's own
``record_function`` spans), the device's busy time over the window and the
idle gaps between operations, named by the host span that was open then.

Timestamps of the export are microseconds on one clock for host and
device; a kernel is tied to the runtime call that launched it by their
shared ``correlation`` id.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Trace", "traced", "WINDOW_SPAN"]

WINDOW_SPAN = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Op:
    name: str
    ts: float  # microseconds
    dur: float
    cat: str
    span: Optional[str] = None  # innermost benchmark span open at the launch


@dataclass
class Trace:
    ops: List[Op]
    spans: List[Tuple[str, float, float]]  # (name, ts, dur) of benchmark spans
    window: Tuple[float, float]  # (ts, dur) of the traced window
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] * 1e-6

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        iv = sorted((max(o.ts, w0), min(o.ts + o.dur, w1)) for o in self.ops)
        merged: List[List[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def kernels(self, like: str = "") -> List[Op]:
        return [o for o in self.ops if o.cat == "kernel" and like in o.name]

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside spans ``name``."""
        return sum(o.dur for o in self.ops if o.span == name) * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        by = collections.Counter()
        for o in self.ops:
            by[o.name[:120]] += o.dur * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps with no device operation inside the window,
        each named by the benchmark span and host operation open at its start."""
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        gaps, last = [], w0
        for a, b in self._busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if w1 > last:
            gaps.append((last, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            span = _innermost(self.spans, a) or "window"
            host = _innermost(self.host_ops, a)
            out.append([f"{span}: {host}" if host else span, (b - a) * 1e-6])
        return out


def _innermost(items, ts: float) -> Optional[str]:
    """The name of the shortest (name, start, duration) interval holding ts."""
    best = None
    for name, a, d in items:
        if a <= ts <= a + d and (best is None or d < best[1]):
            best = (name, d)
    return None if best is None else best[0]


def _parse(events: list, span_names) -> Trace:
    launches: Dict[int, float] = {}
    ops, spans, host_ops = [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cat in _DEVICE_CATS:
            ops.append((Op(name, ts, dur, cat), e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            if name == WINDOW_SPAN:
                window = (ts, dur)
            elif name in span_names:
                spans.append((name, ts, dur))
        elif cat == "cpu_op":
            host_ops.append((name, ts, dur))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    starts = sorted(spans, key=lambda s: s[1])
    keys = [s[1] for s in starts]
    out = []
    for op, corr in ops:
        at = launches.get(corr)
        if at is not None:
            op.span = _innermost(starts[: bisect.bisect_right(keys, at)], at)
        out.append(op)
    return Trace(out, spans, window, host_ops)


def traced(fn, span_names) -> Trace:
    """Run ``fn()`` under the profiler inside the window span, synchronised at
    its end, and return the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return _parse(events, set(span_names))
