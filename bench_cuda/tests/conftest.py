"""Shared pieces of the benchmark's CPU tests: the checkout on the import
path, the ``card`` marker (tests that need a CUDA device; each skips inside
its fixture when there is none), and cells shrunk to a size the CPU runs in
seconds, driven through the whole harness but its look for a card.

    python3 -m pytest bench_cuda/tests -q
"""
import contextlib
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_cuda import harness, spec  # noqa: E402

# every size cut but the denoisers' width (fixed at 128)
TINY_NET = dict(d_model=16, n_heads=2, e_layers=1, d_layers=1, d_ff=16, n_z_samples=8,
                windows=24, pred_len=12, seq_len=24, label_len=12, rolling_length=8,
                p_hidden_dims=[8, 8])
SEED = 2 ** 40 + 12345  # beyond 32 bits: seeds may not fit a signed 32-bit integer


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


def tiny_cell(name, here=spec.HERE, bench=None):
    cell = spec.Cell(bench or spec.load_benchmark(), name, here)
    cell.config["net"].update(TINY_NET)
    if cell.config["reference"] == "tmdm":
        cell.config["net"]["diffusion_steps"] = 10
    t = cell.traffic
    if t["driver"] == "mpv_sweep":
        t.update(nodes=min(t["nodes"], 3), windows=min(t["windows"], 6),
                 chunk_windows=min(t["chunk_windows"], 4), check_windows=4, warmup_calls=1)
    else:
        t.update(batch=8, corpus_windows=64, corpus_series_windows=32, warmup_steps=4)
    return cell


@contextlib.contextmanager
def kernel_arithmetic():
    """The samplers' step through the step kernels' wrappers on the CPU too,
    which run the kernels' plain twins there (bf16 products, float32
    activations), so a CPU run does the card's arithmetic."""
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.models.tmdm import TMDMModel

    saved = {cls: cls.denoiser_fn for cls in (NsDiffModel, TMDMModel)}
    for cls, orig in saved.items():
        cls.denoiser_fn = lambda self, a, b, use_kernel=None, _o=orig: _o(self, a, b, True)
    try:
        yield
    finally:
        for cls, orig in saved.items():
            cls.denoiser_fn = orig


def run_tiny(cell, fault=None, readings=False, seed=SEED):
    with kernel_arithmetic():
        return harness.execute(cell, seed, 0.5, False, "cpu", time.perf_counter(), fault,
                               readings)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
