"""One torch thread for the port's test files (imported by each).

Under pytest-xdist several worker processes share the CPUs, and torch's
intra-op pool takes every CPU in each of them: a parallel region then waits
at its barrier for threads the other workers hold, and element-wise chains
on small tensors (the twins of the CUDA kernels, the sweeps) ran tens of
times slower than on one thread. The fixture sets
one thread for a module's tests and gives the worker its setting back.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
