"""The benchmark of ``upgdm_tpu_torch``, the PyTorch and CUDA port: a
data-driven harness (``run.py``) over the cells of ``BENCHMARK.json``."""
