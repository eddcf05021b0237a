"""K3 — fused TMDM denoiser step (wrapper of ``csrc/fused_tmdm.cu``).

Counterpart of the TMDM variant in ``upgdm_tpu/ops/pallas/fused_denoiser.py``
(``fused_tmdm_rows``, ``fused_tmdm_denoiser``). For M rows of
x = [y_t, y0_hat] the step computes

    h = softplus(gamma_i * (h @ W_i + b_i))      i = 1, 2, 3
    eps = h @ W4 + b4

with no normalisation between layers and a single head; only the
``cat_y_pred=True`` input layout of ``TMDMDenoiser`` has this form. Weights
use the flax layout (``W [in, out]``). ``matmul_dtype="bfloat16"`` (the
default, as in the JAX package) rounds both dot operands to bf16 and
accumulates in float32; gates, biases and softplus stay float32.

``fused_tmdm_rows`` launches the CUDA kernel for CUDA tensors and runs
``fused_tmdm_rows_reference`` (the plain PyTorch twin) for CPU tensors. On
the card ``"bfloat16"`` is the tensor-core kernel (``csrc/trunk_mma.cuh``)
and ``"float32"`` the CUDA-core kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .fused_denoiser import (
    HIDDEN,
    MAX_F,
    _check_mat,
    _check_vec,
    _dot,
    _hidden_shape,
    check_dtypes,
    denoiser_gammas,
    step_weights,
)

__all__ = [
    "fused_tmdm_rows",
    "fused_tmdm_rows_reference",
    "fused_tmdm_denoiser",
    "tmdm_weights",
    "tmdm_gammas",
]

#: per-timestep gates (g1, g2, g3) of a TMDMDenoiser at scalar t: the three
#: ``embed`` tables are laid out as NsDiff's
tmdm_gammas = denoiser_gammas


def tmdm_weights(denoiser) -> Tuple[torch.Tensor, ...]:
    """(W1, b1, W2, b2, W3, b3, W4, b4) of a TMDMDenoiser, with every matrix
    in the flax layout [in, out]."""
    d = denoiser
    return tuple(
        t.detach() for t in (
            d.lin1.Dense_0.weight.t(), d.lin1.Dense_0.bias,
            d.lin2.Dense_0.weight.t(), d.lin2.Dense_0.bias,
            d.lin3.Dense_0.weight.t(), d.lin3.Dense_0.bias,
            d.lin4.weight.t(), d.lin4.bias,
        )
    )


def fused_tmdm_rows_reference(x, gammas, weights, matmul_dtype="bfloat16"):
    """Plain PyTorch twin of K3: x [M, 2F] -> eps [M, F]."""
    mm = check_dtypes(matmul_dtype, "float32")
    W1, b1, W2, b2, W3, b3, W4, b4 = weights
    h = x.float()
    for W, b, g in ((W1, b1, gammas[0]), (W2, b2, gammas[1]), (W3, b3, gammas[2])):
        h = F.softplus(g * (_dot(h, W, mm) + b))
    return _dot(h, W4, mm) + b4


def fused_tmdm_rows(x: torch.Tensor, gammas: Sequence[torch.Tensor], weights,
                    matmul_dtype: str = "bfloat16") -> torch.Tensor:
    """x: [M, 2F] float32 rows of concat(y_t, y0_hat) -> eps [M, F] float32.

    CUDA tensors launch K3 on ``weights`` as ``step_weights`` prepared them;
    CPU tensors run the plain twin on the flax-layout tuple.
    """
    if x.device.type == "cpu":
        return fused_tmdm_rows_reference(x, gammas, weights, matmul_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tmdm_rows: unsupported device {x.device}")
    mm = check_dtypes(matmul_dtype, "float32")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 [M, 2F], got {x.dtype} {tuple(x.shape)}")
    M, in_dim = x.shape
    Fdim = in_dim // 2
    if in_dim != 2 * Fdim or not 1 <= Fdim <= MAX_F:
        raise ValueError(f"x: expected 2F columns with 1 <= F <= {MAX_F}, got {in_dim}")
    dev = x.device
    W1, b1, W2, b2, W3, b3, W4, b4 = weights
    g1, g2, g3 = (g.float().contiguous() for g in gammas)
    for name, g in (("g1", g1), ("g2", g2), ("g3", g3), ("b1", b1), ("b2", b2), ("b3", b3)):
        _check_vec(name, g, HIDDEN, dev)
    _check_vec("b4", b4, Fdim, dev)
    _check_mat("W1", W1, (in_dim, HIDDEN), mm, dev)
    _check_mat("W2", W2, _hidden_shape(mm), mm, dev)
    _check_mat("W3", W3, _hidden_shape(mm), mm, dev)
    _check_mat("W4", W4, (HIDDEN, Fdim), mm, dev)
    eps = torch.empty((M, Fdim), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr()
    code = lib.upgdm_fused_tmdm(
        ptr(x), M, Fdim, ptr(g1), ptr(g2), ptr(g3), ptr(W1), ptr(b1), ptr(W2), ptr(b2),
        ptr(W3), ptr(b3), ptr(W4), ptr(b4), ptr(eps), int(mm == torch.bfloat16), stream,
    )
    _build.check(code, "fused_tmdm")
    fused_tmdm_rows.launches += 1
    return eps


fused_tmdm_rows.launches = 0


def fused_tmdm_denoiser(denoiser, y_t, y_0_hat, t: int, matmul_dtype: str = "bfloat16"):
    """Drop-in for ``TMDMDenoiser(x_emb, y_t, y_0_hat, t)`` (the
    ``cat_y_pred=True`` layout) at scalar t.

    y_t / y_0_hat: [..., O, F]. Returns eps with that shape.
    """
    x = torch.cat([y_t, y_0_hat], dim=-1)
    lead = x.shape[:-1]
    Fdim = y_t.shape[-1]
    rows = x.reshape(-1, x.shape[-1]).float().contiguous()
    weights = tmdm_weights(denoiser)
    if rows.is_cuda:
        weights = step_weights(weights, check_dtypes(matmul_dtype, "float32"))
    eps = fused_tmdm_rows(rows, tmdm_gammas(denoiser, t), weights, matmul_dtype=matmul_dtype)
    return eps.reshape(*lead, Fdim)
