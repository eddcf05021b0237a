"""A cell, a traffic mix, its limits and a per-layer metric added as files
and entries in a copy of the benchmark are found by name with no edit to any
code; and the command refuses to run without a card."""
import json
import shutil
import subprocess
import sys

from conftest import ROOT, run_tiny, tiny_cell
from bench_cuda import spec


def test_added_files_are_found_without_code_edits(tmp_path):
    here = tmp_path / "bench_cuda"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((here / "traffic" / "mpv_sweep_30node_16w.json").read_text())
    traffic.update(nodes=2, windows=5, chunk_windows=2)
    (here / "traffic" / "mpv_sweep_2node_5w.json").write_text(json.dumps(traffic))
    (here / "limits" / "tmdm_sweep_2node.json").write_text(
        json.dumps(json.loads((here / "limits" / "tmdm_sweep.json").read_text())))
    (here / "metrics" / "windows_checked.py").write_text(
        "def read(ctx):\n    return ctx.info.get('series_per_chunk')\n")
    bench["workloads"].append({"name": "tmdm_sweep_2node", "config": "tmdm_d64",
                               "traffic": "mpv_sweep_2node_5w", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tmdm_sweep" in m.get("workloads", ()):
            m["workloads"].append("tmdm_sweep_2node")
    bench["per_layer"].append({"name": "windows_checked", "unit": "series", "better": "higher",
                               "source": "program_counter", "layer": "sweep",
                               "moves": "windows_per_hr", "workloads": ["tmdm_sweep_2node"]})
    cell = spec.Cell(bench, "tmdm_sweep_2node", here)
    assert cell.traffic["nodes"] == 2 and cell.config["net"]["task_model"] == "TMDM"
    assert "windows_checked" in [m["name"] for m in cell.per_layer]
    assert spec.reader("windows_checked", here).read(
        type("Ctx", (), {"info": {"series_per_chunk": 4}})()) == 4
    result = run_tiny(tiny_cell("tmdm_sweep_2node", here, bench))
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"windows_per_hr", "setup_s"}


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the refusal is for machines without one
    out = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload", "nsdiff_sweep",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
