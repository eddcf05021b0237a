"""One run of one cell: set-up, the measured (or traced) window, the
comparison that decides ``correct``, and the result line.

``main`` is the command line's path: it refuses to run without as many CUDA
devices as the cell asks for, and fails if JAX, flax, optax or the JAX
package got loaded. ``execute`` is the rest of a run, on any device, for the
tests that drive a whole run on the CPU at a small size.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

from . import devtrace, spec

# top-level module names a run must not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "upgdm_tpu")


class Run:
    """What a driver gets: the cell, the run's arguments, and the hooks that
    mark the end of set-up, read the memory peak and trace a window."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
                 t_start: float, fault: Optional[str] = None, readings: bool = False):
        self.cell, self.seed, self.seconds, self.traced = cell, int(seed), float(seconds), traced
        self.device, self.t_start, self.fault, self.readings = device, t_start, fault, readings
        self.setup_s: Optional[float] = None
        self.marks = [("start", 0.0)]
        self.memory_peak_bytes = 0
        self.trace: Optional[devtrace.Trace] = None

    def mark(self, label: str):
        """End of a part of set-up (its seconds go to the result's ``setup_parts``)."""
        self.marks.append((label, time.perf_counter() - self.t_start))

    def setup_done(self):
        self.mark("warm-up")
        self.setup_s = self.marks[-1][1]

    def setup_parts(self) -> dict:
        return {b[0]: b[1] - a[1] for a, b in zip(self.marks, self.marks[1:])}

    def read_memory(self):
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def trace_run(self, fn, span_names):
        self.trace = devtrace.traced(fn, span_names)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _smi() -> dict:
    """The card's name, power limit and highest SM clock from nvidia-smi
    (empty where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        name, limit, clock = [s.strip() for s in out.stdout.splitlines()[0].split(",")]
        return {"smi_name": name, "power_limit_w": float(limit), "sm_clock_max_mhz": float(clock)}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {}


class ReadContext:
    """What a per-layer metric's reader sees."""

    def __init__(self, cell, trace, info, sm_clock_hz):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.trace, self.info, self.sm_clock_hz = trace, info, sm_clock_hz


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
            t_start: float, fault: Optional[str] = None, readings: bool = False) -> dict:
    """Run the cell and return the result (without the chip check)."""
    import importlib

    r = Run(cell, seed, seconds, traced, device, t_start, fault, readings)
    out = importlib.import_module(f"{__package__}.drivers.{cell.traffic['driver']}").run(r)
    limits = cell.limits["limits"]
    checks = {k: {"value": out["checks"][k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and out["failed"] == 0
    gpu = device.startswith("cuda")
    smi = _smi() if gpu else {}
    dev = {"platform": "gpu" if gpu else "cpu", "kind": _kind(device), "count": cell.chips,
           "memory_peak_bytes": r.memory_peak_bytes}
    dev.update(smi)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if traced:
        clock = smi.get("sm_clock_max_mhz")
        ctx = ReadContext(cell, r.trace, out["info"], clock * 1e6 if clock else None)
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
    else:
        values = dict(out["e2e"], setup_s=r.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=dev)
    if traced:
        result["breakdown"] = {"device_ops": r.trace.top_ops(10),
                               "idle_gaps": r.trace.idle_gaps(10)}
    result["setup_parts"] = r.setup_parts()
    if readings:
        result["readings"] = dict(out["readings"], numbers=out["checks"])
    result["checks"] = checks
    return result


def _kind(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    import platform

    return platform.processor() or "cpu"


def main(args, t_start: float) -> int:
    import torch

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_cuda: {cell.chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                     args.fault, bool(args.readings))
    bad = forbidden_modules()
    if bad:
        print(f"bench_cuda: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
