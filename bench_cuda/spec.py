"""What ``BENCHMARK.json`` names, found by name among the benchmark's files:
a cell's configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the limits of its correctness numbers
(``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or None).
Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no code here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "find_cell", "reader"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = _json(here / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")
        self.end_to_end: List[dict] = [m for m in bench["end_to_end"] if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer: List[dict] = [m for m in bench["per_layer"]
                                      if _applies(m, name) and m["moves"] in reported]


def find_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    return Cell(load_benchmark(root), name, here)


def reader(metric: str, here: Path = HERE):
    """The module ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"bench_cuda_metric_{metric}",
                                                  here / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
