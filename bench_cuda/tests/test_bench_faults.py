"""Whole runs of every cell at a small size on the CPU (everything but the
look for a card): sound, each comes out ``correct``; with each fault of
``faults.py`` planted in the program underneath it does not, nor does the
control (the reference one precision step below what the configuration
states) in a sweep's place. The training cell's control is TF32, which only
a card has: ``test_bench_card.py`` holds it there."""
import pytest

from conftest import run_tiny, tiny_cell
from bench_cuda import faults, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in (faults.TRAIN if spec.find_cell(c).traffic["driver"] == "train_step"
                   else faults.SWEEP)]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_tiny(tiny_cell(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in spec.find_cell(name).end_to_end}


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    result = run_tiny(tiny_cell(name), fault=fault)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("name", [c for c in CELLS
                                  if spec.find_cell(c).traffic["driver"] == "mpv_sweep"])
def test_control_fails_the_limits(name):
    result = run_tiny(tiny_cell(name), readings=True)
    control = result["readings"]["control"]
    limits = spec.find_cell(name).limits["limits"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)
