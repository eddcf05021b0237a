"""BENCHMARK.json against the rules a benchmark file is held to, and every
name in it resolved to its files."""
import json
import re

import pytest

from conftest import ROOT
from bench_cuda import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|hidden_size|n_heads|p_hidden_dims)$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def _line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_shape_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    groups = (("config", BENCH["configs"]), ("workload", BENCH["workloads"]),
              ("end_to_end", BENCH["end_to_end"]), ("per_layer", BENCH["per_layer"]))
    for kind, entries in groups:
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), kind
        for e in entries:
            assert set(e) <= KEYS[kind] and set(e) >= KEYS[kind] - {"workloads"}, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if kind in ("end_to_end", "per_layer"):
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer") + (("source",) if kind == "config" else ()):
                assert k not in e or _line(e[k]), (e["name"], k)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["source"].startswith("https://") and _line(c["source"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
        assert set(c["reduced"]) <= set(body["source_values"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_and_reports(name):
    cell = spec.find_cell(name)
    assert (spec.HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert (spec.HERE / "reference" / f"{cell.config['reference']}.py").exists()
    assert cell.limits["limits"] and all(v > 0 for v in cell.limits["limits"].values())
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_check_time_fits():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
