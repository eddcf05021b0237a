"""K1 — fused NsDiff denoiser step (wrapper of ``csrc/fused_denoiser.cu``).

Counterpart of ``upgdm_tpu/ops/pallas/fused_denoiser.py``. For M rows of
x = [y_t, y0_hat, gx] the step computes

    h = l2norm(softplus(gamma_i * (h @ W_i + b_i)))      i = 1, 2, 3
    eps = h @ W4 + b4 ; sigma = softplus(softplus(h) @ Ws + bs)

with ``l2norm(v) = v * rsqrt(max(sum v^2, 1e-24))``. Weights use the flax
layout (``W [in, out]``). ``matmul_dtype="bfloat16"`` rounds both dot
operands to bf16 and accumulates in float32. ``act_dtype="bfloat16"`` (it
needs bf16 matmuls, as in the JAX package) runs the gate, softplus and norm
in bf16, rounded after every operation (``act_band``); the heads stay as in
the float32 arm.

``fused_denoiser_rows`` launches the CUDA kernel for CUDA tensors and runs
``fused_denoiser_rows_reference`` (the plain PyTorch twin) for CPU tensors.
On the card ``"bfloat16"`` is the tensor-core kernel (``csrc/trunk_mma.cuh``)
and ``"float32"`` the CUDA-core kernel. On the card the wrappers take what
``step_weights`` made of the flax-layout tuple, once for many launches: for
bf16 it lays W2 and W3 out in the order the tensor-core product reads them
(``tile_b_operand``). The plain twins, and so the wrappers on CPU tensors,
take the flax-layout tuple itself.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "HIDDEN",
    "MAX_F",
    "fused_denoiser_rows",
    "fused_denoiser_rows_reference",
    "fused_nsdiff_denoiser",
    "denoiser_weights",
    "denoiser_gammas",
    "check_dtypes",
    "act_bf16",
    "act_band",
    "kernel_weights",
    "step_weights",
    "tile_b_operand",
    "untile_b_operand",
]

HIDDEN = 128
MAX_F = 4  # csrc/denoiser_trunk.cuh::MAX_F
_EPS_NORM_SQ = 1e-24
_MATMUL = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _dtype(name: str, value) -> torch.dtype:
    try:
        return _MATMUL[str(value)]
    except KeyError:
        raise ValueError(f"{name}={value!r}: expected one of {sorted(_MATMUL)}") from None


def check_dtypes(matmul_dtype: str, act_dtype: str, chain: bool = False) -> torch.dtype:
    """The matmul dtype, after the JAX package's rules: bf16 activations need
    bf16 matmuls in the step kernel (``fused_denoiser.py:170-172``); the chain
    kernel (``chain=True``) takes all four combinations."""
    mm = _dtype("matmul_dtype", matmul_dtype)
    if act_bf16(act_dtype) and mm == torch.float32 and not chain:
        raise ValueError("act_dtype=bfloat16 requires matmul_dtype=bfloat16 "
                         "(the trunk products consume the bf16 activations)")
    return mm


def act_bf16(act_dtype: str) -> bool:
    """Whether ``act_dtype`` asks for bf16 activations (a typo raises)."""
    return _dtype("act_dtype", act_dtype) == torch.bfloat16


def act_band(out: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One hidden layer's band with bf16 activations, as the TPU kernels
    compute it (``fused_denoiser.py:125-139``, ``chain_resident.py:87-93``):
    the float32 product rounded to bf16, the gate g (o + b) and the
    branch-free softplus log(1 + exp(-|o|)) + 0.5 (o + |o|) in bf16 with a
    rounding after every operation, the squares rounded before a float32
    sum, and h = o * bf16(rsqrt(max(s2, 1e-24))). Returns float32 holding
    bf16 values."""
    bf = torch.bfloat16
    o = g.to(bf) * (out.to(bf) + b.to(bf))
    ax = o.abs()
    o = torch.log(1.0 + torch.exp(-ax)) + 0.5 * (o + ax)
    s2 = (o * o).float().sum(dim=-1, keepdim=True)
    return (o * torch.rsqrt(torch.clamp(s2, min=_EPS_NORM_SQ)).to(bf)).float()


def denoiser_weights(denoiser) -> Tuple[torch.Tensor, ...]:
    """(W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs) of an NsDiffDenoiser, with
    every matrix in the flax layout [in, out]."""
    d = denoiser
    return tuple(
        t.detach() for t in (
            d.lin1.Dense_0.weight.t(), d.lin1.Dense_0.bias,
            d.lin2.Dense_0.weight.t(), d.lin2.Dense_0.bias,
            d.lin3.Dense_0.weight.t(), d.lin3.Dense_0.bias,
            d.lin4.weight.t(), d.lin4.bias,
            d.sigma_lin.weight.t(), d.sigma_lin.bias,
        )
    )


def denoiser_gammas(denoiser, t: int) -> Tuple[torch.Tensor, ...]:
    """Per-timestep gates (g1, g2, g3), each [HIDDEN], for scalar t."""
    d = denoiser
    return tuple(e.detach()[t] for e in (d.lin1.embed, d.lin2.embed, d.lin3.embed))


def _dot(a: torch.Tensor, w: torch.Tensor, mm: torch.dtype) -> torch.Tensor:
    if mm == torch.bfloat16:  # bf16 operands, exact products, float32 sums
        a = a.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    return a @ w


def _f32_band(out, g, b):
    out = F.softplus(g * (out + b))
    s2 = (out * out).sum(dim=-1, keepdim=True)
    return out * torch.rsqrt(torch.clamp(s2, min=_EPS_NORM_SQ))


def fused_denoiser_rows_reference(x, gammas, weights, matmul_dtype="float32",
                                  act_dtype="float32"):
    """Plain PyTorch twin of K1: x [M, 3F] -> (eps [M, F], sigma [M, F])."""
    mm = check_dtypes(matmul_dtype, act_dtype)
    band = act_band if act_bf16(act_dtype) else _f32_band
    W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs = weights
    h = x.float()
    for W, b, g in ((W1, b1, gammas[0]), (W2, b2, gammas[1]), (W3, b3, gammas[2])):
        h = band(_dot(h, W, mm), g, b)
    eps = _dot(h, W4, mm) + b4
    sigma = F.softplus(_dot(F.softplus(h), Ws, mm) + bs)
    return eps, sigma


def _check_vec(name, t, n, device):
    if t.device != device or t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 [{n}] on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_mat(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def kernel_weights(weights, mm: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Weights as the CUDA-core kernels (the float32 arms of K1, K2 and K3)
    take them: contiguous matrices in the matmul dtype (bf16 rounding is
    round-to-nearest-even), float32 biases."""
    return tuple(
        (w.to(mm) if i % 2 == 0 else w.float()).contiguous() for i, w in enumerate(weights)
    )


_KBLOCK = 64  # k values (128 bytes of bf16) in one swizzle row
TILED_SHAPE = (HIDDEN // _KBLOCK, HIDDEN, _KBLOCK)


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """[n, k-block, chunk, 8] with chunk c of row n moved to c ^ (n % 8); the
    move is its own inverse."""
    n = torch.arange(HIDDEN, device=t.device)
    idx = torch.arange(8, device=t.device)[None, :] ^ (n % 8)[:, None]  # [n, chunk]
    return t.gather(2, idx[:, None, :, None].expand_as(t))


def tile_b_operand(W: torch.Tensor) -> torch.Tensor:
    """A hidden matrix W [128 in, 128 out] (flax layout) in the order the
    tensor-core kernels stage it: ``[2, 128, 64]`` = (k block, output n, k in
    block), K-major with the 128-byte swizzle of ``csrc/trunk_mma.cuh`` (the
    16-byte chunk c of row n sits at chunk ``c ^ (n % 8)``). Element (k, n)
    lands at flat offset ``(k // 64) * 8192 + n * 64 + (((k % 64) // 8) ^
    (n % 8)) * 8 + k % 8``."""
    if tuple(W.shape) != (HIDDEN, HIDDEN):
        raise ValueError(f"tile_b_operand: expected [{HIDDEN}, {HIDDEN}], got {tuple(W.shape)}")
    t = W.t().reshape(HIDDEN, HIDDEN // _KBLOCK, 8, 8)  # [n, k block, chunk, 8]
    return _swizzle(t).permute(1, 0, 2, 3).reshape(TILED_SHAPE).contiguous()


def untile_b_operand(T: torch.Tensor) -> torch.Tensor:
    """Inverse of ``tile_b_operand``: the flax-layout matrix [in, out]."""
    if tuple(T.shape) != TILED_SHAPE:
        raise ValueError(f"untile_b_operand: expected {TILED_SHAPE}, got {tuple(T.shape)}")
    t = T.reshape(HIDDEN // _KBLOCK, HIDDEN, 8, 8).permute(1, 0, 2, 3)
    return _swizzle(t).reshape(HIDDEN, HIDDEN).t().contiguous()


def step_weights(weights, mm: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The one preparation of a flax-layout weight tuple for the kernels on
    the card (K1, K3 and, through ``chain_operands``, K2): ``kernel_weights``
    and, for bf16, W2 and W3 (positions 2 and 4) tiled for the tensor-core
    product. A tuple already prepared comes back unchanged."""
    out = list(kernel_weights(weights, mm))
    if mm == torch.bfloat16:
        for i in (2, 4):
            if tuple(out[i].shape) != TILED_SHAPE:
                out[i] = tile_b_operand(out[i])
    return tuple(out)


def _hidden_shape(mm: torch.dtype):
    return TILED_SHAPE if mm == torch.bfloat16 else (HIDDEN, HIDDEN)


def fused_denoiser_rows(x: torch.Tensor, gammas: Sequence[torch.Tensor], weights,
                        matmul_dtype: str = "float32", act_dtype: str = "float32"):
    """x: [M, 3F] float32 rows -> (eps [M, F], sigma [M, F]) float32.

    CUDA tensors launch K1 on ``weights`` as ``step_weights`` prepared them;
    CPU tensors run the plain twin on the flax-layout tuple.
    """
    if x.device.type == "cpu":
        return fused_denoiser_rows_reference(x, gammas, weights, matmul_dtype, act_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_denoiser_rows: unsupported device {x.device}")
    mm = check_dtypes(matmul_dtype, act_dtype)
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 [M, 3F], got {x.dtype} {tuple(x.shape)}")
    M, in_dim = x.shape
    Fdim = in_dim // 3
    if in_dim != 3 * Fdim or not 1 <= Fdim <= MAX_F:
        raise ValueError(f"x: expected 3F columns with 1 <= F <= {MAX_F}, got {in_dim}")
    dev = x.device
    W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs = weights
    g1, g2, g3 = (g.float().contiguous() for g in gammas)
    for name, g in (("g1", g1), ("g2", g2), ("g3", g3), ("b1", b1), ("b2", b2), ("b3", b3)):
        _check_vec(name, g, HIDDEN, dev)
    _check_vec("b4", b4, Fdim, dev)
    _check_vec("bs", bs, Fdim, dev)
    _check_mat("W1", W1, (in_dim, HIDDEN), mm, dev)
    _check_mat("W2", W2, _hidden_shape(mm), mm, dev)
    _check_mat("W3", W3, _hidden_shape(mm), mm, dev)
    _check_mat("W4", W4, (HIDDEN, Fdim), mm, dev)
    _check_mat("Ws", Ws, (HIDDEN, Fdim), mm, dev)
    eps = torch.empty((M, Fdim), dtype=torch.float32, device=dev)
    sigma = torch.empty((M, Fdim), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr()
    code = lib.upgdm_fused_denoiser(
        ptr(x), M, Fdim, ptr(g1), ptr(g2), ptr(g3), ptr(W1), ptr(b1), ptr(W2), ptr(b2),
        ptr(W3), ptr(b3), ptr(W4), ptr(b4), ptr(Ws), ptr(bs), ptr(eps), ptr(sigma),
        int(mm == torch.bfloat16), int(act_bf16(act_dtype)), stream,
    )
    _build.check(code, "fused_denoiser")
    fused_denoiser_rows.launches += 1
    fused_denoiser_rows.launches_act_bf16 += int(act_bf16(act_dtype))
    return eps, sigma


fused_denoiser_rows.launches = 0
fused_denoiser_rows.launches_act_bf16 = 0


def fused_nsdiff_denoiser(denoiser, y_t, y_0_hat, g_x, t: int,
                          matmul_dtype: str = "float32", act_dtype: str = "float32"):
    """Drop-in for ``NsDiffDenoiser(y_t, y_0_hat, g_x, t)`` at scalar t.

    y_t / y_0_hat / g_x: [..., O, F]. Returns (eps, sigma) with that shape.
    """
    x = torch.cat([y_t, y_0_hat, g_x], dim=-1)
    lead = x.shape[:-1]
    Fdim = y_t.shape[-1]
    rows = x.reshape(-1, x.shape[-1]).float().contiguous()
    weights = denoiser_weights(denoiser)
    if rows.is_cuda:
        weights = step_weights(weights, check_dtypes(matmul_dtype, act_dtype))
    eps, sigma = fused_denoiser_rows(
        rows, denoiser_gammas(denoiser, t), weights,
        matmul_dtype=matmul_dtype, act_dtype=act_dtype,
    )
    return eps.reshape(*lead, Fdim), sigma.reshape(*lead, Fdim)
