"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Counterpart of ``upgdm_tpu/ops/pallas/``. Each wrapper runs its CUDA kernel
for CUDA tensors and its plain twin for CPU tensors; nothing falls back from
one to the other. Each wrapper counts its kernel launches in ``.launches``.
"""
