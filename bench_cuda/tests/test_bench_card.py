"""On a card: a short run of each cell at its own size is correct and
reports every metric the cell names, traced and not, and the control read in
the same run fails one of the cell's limits. Skips without a CUDA device.

    python3 -m pytest bench_cuda/tests/test_bench_card.py -q
"""
import time

import pytest

from bench_cuda import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name, traced):
    cell = spec.find_cell(name)
    result = harness.execute(cell, 2 ** 33 + 1, 2.0, traced, "cuda", time.perf_counter(),
                             readings=True)
    assert result["correct"], result["checks"]
    control, limits = result["readings"]["control"], cell.limits["limits"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)
    want = cell.per_layer if traced else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
