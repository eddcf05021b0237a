"""K2 — the whole NsDiff reverse chain in one launch (wrapper of
``csrc/chain_resident.cu``).

Counterpart of ``upgdm_tpu/ops/pallas/chain_resident.py``. For M rows of
(y0_hat, gx) the chain starts from y_T = sqrt(gx) * z + y0_hat, runs the K1
trunk and the heteroscedastic posterior update for t = T-1 .. 1, and ends
with the deterministic reparameterisation at t = 0 — the arithmetic of
``ops/diffusion.py::nsdiff_p_sample_loop`` with the trunk's first-layer
[y0_hat, gx] partial product hoisted out of the loop.

The kernel draws its noise from Philox4x32-10 keyed by (seed, row, step,
feature pair) with a Box-Muller transform; ``philox_normal_reference`` repeats
that stream in plain PyTorch. The plain twin ``fused_chain_rows_reference``
draws from a ``torch.Generator`` (another stream: sampled chains then agree
in distribution, at the ensemble MPV) or, with ``noise="philox"``, from the
kernel's own stream, which holds a sampled chain to the kernel per sample.
``noise_mode="zero"`` makes both deterministic.

On the card ``matmul_dtype="bfloat16"`` is the tensor-core kernel
(``csrc/trunk_mma.cuh``): it takes W2/W3 in the tiled order of
``step_weights`` and every step's gates as one ``gate_table``;
``chain_operands`` makes both once for many launches. ``"float32"`` is the
CUDA-core parity arm on the flax-layout weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .fused_denoiser import (
    HIDDEN,
    MAX_F,
    _EPS_NORM_SQ,
    _check_mat,
    _check_vec,
    _dot,
    _hidden_shape,
    check_dtypes,
    denoiser_weights,
    step_weights,
)

__all__ = [
    "schedule_table",
    "gate_table",
    "chain_operands",
    "philox4x32_10",
    "philox_normal_reference",
    "fused_chain_rows",
    "fused_chain_rows_reference",
    "fused_nsdiff_chain",
    "MAX_T",
]

MAX_T = 1024  # csrc/chain_resident.cu::MAX_T
_NOISE = ("prng", "zero")
_NOISE_SOURCE = ("generator", "philox")
_MASK32 = 0xFFFFFFFF


def schedule_table(sched) -> np.ndarray:
    """[7, T] float32 row-stack of the per-step schedule arrays."""
    rows = [sched.alphas, sched.betas_tilde, sched.betas_bar,
            sched.betas_tilde_m_1, sched.betas_bar_m_1,
            sched.alphas_cumprod_prev, sched.one_minus_alphas_bar_sqrt]
    return np.ascontiguousarray(np.stack([np.asarray(r, np.float32) for r in rows], axis=0))


def gate_table(gammas_tables, b1, b2, b3) -> torch.Tensor:
    """Every step's gates as the tensor-core arm of K2 reads them: float32
    ``[T, 3, 64, 4]`` with entry (t, layer, p) = (g[2p], g[2p] * b[2p],
    g[2p+1], g[2p+1] * b[2p+1]) for g = E_layer[t] and b the layer's bias
    (``csrc/trunk_mma.cuh::gate_pair``; the gate is then one FMA)."""
    layers = []
    for E, b in zip(gammas_tables, (b1, b2, b3)):
        g = E.detach().float()
        layers.append(torch.stack([g, g * b.detach().float()], dim=-1))  # [T, 128, 2]
    T = layers[0].shape[0]
    return torch.stack(layers, dim=1).reshape(T, 3, HIDDEN // 2, 4).contiguous()


def chain_operands(gammas_tables, weights, mm: torch.dtype):
    """(gates, weights) as K2 takes them on the card, made once for many
    launches: ``step_weights`` of the flax-layout tuple and, for bf16, the
    ``gate_table`` of (E1, E2, E3) and the three trunk biases (float32 keeps
    the tables). Operands already prepared come back unchanged."""
    weights = step_weights(weights, mm)
    if mm == torch.bfloat16 and not isinstance(gammas_tables, torch.Tensor):
        gammas_tables = gate_table(gammas_tables, weights[1], weights[3], weights[5])
    return gammas_tables, weights


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit values, without leaving int64."""
    lo16, hi16 = x & 0xFFFF, x >> 16
    a, b = m * lo16, m * hi16  # each below 2^48
    low = (a + ((b & 0xFFFF) << 16)) & _MASK32
    high = (b + (a >> 16)) >> 16
    return high, low


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words: counter (c0, c1, c2, c3), key (k0, k1) -> four words. The round of
    ``csrc/chain_resident.cu::philox4x32_10``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_normal_reference(seed: int, rows: torch.Tensor, step: int, F: int) -> torch.Tensor:
    """The standard normals K2 draws for global rows ``rows`` (int64 [M]) at
    ``step`` (T for y_T, else t): float32 [M, F]. Counter (row low, row high,
    step, f // 2), key (seed low, seed high); Box-Muller on the first two
    words, cosine for even f and sine for odd f. A value depends on (seed,
    row, step, f) only, never on how many rows are asked for. The transform
    is taken in float64 and rounded once."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    seed = int(seed) & (2**64 - 1)
    key = tuple(torch.full_like(rows, k) for k in (seed & _MASK32, seed >> 32))
    cols = []
    for pair in range((F + 1) // 2):
        counter = (rows & _MASK32, (rows >> 32) & _MASK32, torch.full_like(rows, int(step)),
                   torch.full_like(rows, pair))
        b0, b1, _, _ = philox4x32_10(counter, key)
        # u1 in (0, 1] so log(u1) is finite; 24 bits is all a float32 keeps
        u1 = ((b0 >> 8) + 1).double() / 16777216.0
        u2 = (b1 >> 8).double() / 16777216.0
        rad = torch.sqrt(-2.0 * torch.log(u1))
        cols += [rad * torch.cos(2.0 * torch.pi * u2), rad * torch.sin(2.0 * torch.pi * u2)]
    return torch.stack(cols[:F], dim=-1).float()


def _sigma_y0_hat(a, bt_m1, bb_m1, gx, sigma_theta):
    """Per-step quadratic solve for sigma_Y0 (nsdiff_utils.py:143-146)."""
    lam0 = a * (1.0 - a) * bt_m1
    lam1 = ((1.0 - a) ** 2 * bt_m1 + a * (1.0 - a) * (bb_m1 - bt_m1)) * gx \
        - sigma_theta * (a * bt_m1 + a * (1.0 - a))
    lam2 = gx * gx * (1.0 - a) ** 2 * (bb_m1 - bt_m1) - sigma_theta * gx * (
        a * bb_m1 - a * bt_m1 + (1.0 - a) ** 2
    )
    disc = torch.clamp(lam1 * lam1 - 4.0 * lam0 * lam2, min=0.0)
    return (-lam1 + torch.sqrt(disc)) / (2.0 * lam0)


def fused_chain_rows_reference(y0h, gx, tab, gammas_tables, weights, n_steps,
                               matmul_dtype="bfloat16", act_dtype="float32",
                               noise_mode="prng", use_gx_directly=False,
                               generator=None, noise="generator", seed=0):
    """Plain PyTorch twin of K2: y0h/gx [M, F] -> y_0 [M, F].

    tab: [7, T] schedule table (tensor on the rows' device); gammas_tables:
    (E1, E2, E3) [T, HIDDEN]; weights as ``denoiser_weights``. With
    noise_mode="prng" the normals come from ``generator`` (``torch.randn``)
    or, with noise="philox", from the kernel's stream for rows 0..M-1 under
    ``seed`` (``philox_normal_reference``).
    """
    mm = check_dtypes(matmul_dtype, act_dtype)
    if noise_mode not in _NOISE:
        raise ValueError(f"noise_mode={noise_mode!r}: expected one of {_NOISE}")
    if noise not in _NOISE_SOURCE:
        raise ValueError(f"noise={noise!r}: expected one of {_NOISE_SOURCE}")
    W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs = weights
    E1, E2, E3 = gammas_tables
    Fdim = y0h.shape[-1]
    w1y = W1[:Fdim]
    base1 = _dot(y0h, W1[Fdim:2 * Fdim], mm) + _dot(gx, W1[2 * Fdim:3 * Fdim], mm)

    def band(out, g, b):
        out = F.softplus(g * (out + b))
        s2 = (out * out).sum(dim=-1, keepdim=True)
        return out * torch.rsqrt(torch.clamp(s2, min=_EPS_NORM_SQ))

    def trunk(y, t):
        h = band(_dot(y, w1y, mm) + base1, E1[t], b1)
        h = band(_dot(h, W2, mm), E2[t], b2)
        h = band(_dot(h, W3, mm), E3[t], b3)
        eps = _dot(h, W4, mm) + b4
        sigma = F.softplus(_dot(F.softplus(h), Ws, mm) + bs)
        return eps, sigma

    def normal(like, step):
        if noise == "philox":
            rows = torch.arange(like.shape[0], device=like.device)
            return philox_normal_reference(seed, rows, step, Fdim)
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=torch.float32)

    def noise_var(t, sigma_theta):
        a, bt, bb, bt_m1, bb_m1 = (tab[k, t] for k in range(5))
        if use_gx_directly:
            return gx, bb * gx
        s_y0 = _sigma_y0_hat(a, bt_m1, bb_m1, gx, sigma_theta)
        return s_y0, (bb - bt) * gx + bt * s_y0

    y = torch.sqrt(gx) * normal(y0h, n_steps) + y0h if noise_mode == "prng" else y0h
    for t in range(n_steps - 1, -1, -1):
        eps_theta, sigma_theta = trunk(y, t)
        sqrt_abar = torch.sqrt(1.0 - tab[6, t] * tab[6, t])
        s_y0, nvar = noise_var(t, sigma_theta)
        y0_reparam = (y - (1.0 - sqrt_abar) * y0h - eps_theta * torch.sqrt(nvar)) / sqrt_abar
        if t == 0:
            return y0_reparam  # deterministic last step (p_sample_t_1to0)
        a, bt_m1, bb_m1, acp_prev = tab[0, t], tab[3, t], tab[4, t], tab[5, t]
        s1 = (1.0 - a) ** 2 * gx + a * (1.0 - a) * s_y0
        s2 = (bb_m1 - bt_m1) * gx + bt_m1 * s_y0
        denom = a * s2 + s1
        sqrt_a = torch.sqrt(a)
        sqrt_abar_prev = torch.sqrt(acp_prev)
        g0 = sqrt_abar_prev * s1 / denom
        g1 = sqrt_a * s2 / denom
        g2 = ((sqrt_a * (a - 1.0)) * s2 + (1.0 - sqrt_abar_prev) * s1) / denom
        y = g0 * y0_reparam + g1 * y + g2 * y0h
        if noise_mode == "prng":
            y = y + torch.sqrt(sigma_theta) * normal(y, t)
    raise ValueError("n_steps must be >= 1")


def fused_chain_rows(y0h, gx, tab, seed, gammas_tables, weights, n_steps,
                     matmul_dtype="bfloat16", act_dtype="float32", noise_mode="prng",
                     use_gx_directly=False):
    """y0h/gx: [M, F] rows -> y_0 [M, F] after the full reverse chain.

    CUDA tensors launch K2 (Philox noise keyed by ``seed``) on
    ``gammas_tables`` (E1, E2, E3) and the flax-layout ``weights``, or on what
    ``chain_operands`` made of them; CPU tensors run the plain twin on the
    tables and the flax-layout tuple with a ``torch.Generator`` seeded by
    ``seed``.
    """
    if y0h.device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed))
        return fused_chain_rows_reference(
            y0h.float(), gx.float(), torch.as_tensor(tab, dtype=torch.float32),
            gammas_tables, weights, n_steps, matmul_dtype, act_dtype, noise_mode,
            use_gx_directly, generator=gen,
        )
    if y0h.device.type != "cuda":
        raise ValueError(f"fused_chain_rows: unsupported device {y0h.device}")
    mm = check_dtypes(matmul_dtype, act_dtype)
    if noise_mode not in _NOISE:
        raise ValueError(f"noise_mode={noise_mode!r}: expected one of {_NOISE}")
    dev = y0h.device
    for name, t in (("y0h", y0h), ("gx", gx)):
        if t.device != dev or t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 [M, F] on {dev}")
    if gx.shape != y0h.shape:
        raise ValueError(f"gx {tuple(gx.shape)} and y0h {tuple(y0h.shape)} differ")
    M, Fdim = y0h.shape
    if not 1 <= Fdim <= MAX_F or not 1 <= n_steps <= MAX_T:
        raise ValueError(f"F={Fdim} (max {MAX_F}) or T={n_steps} (max {MAX_T}) out of range")
    tab = torch.as_tensor(tab, dtype=torch.float32, device=dev).contiguous()
    _check_mat("tab", tab, (7, n_steps), torch.float32, dev)
    bf16 = mm == torch.bfloat16
    gammas_tables, weights = chain_operands(gammas_tables, weights, mm)
    W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs = weights
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        _check_vec(name, b, HIDDEN, dev)
    _check_vec("b4", b4, Fdim, dev)
    _check_vec("bs", bs, Fdim, dev)
    _check_mat("W1", W1, (3 * Fdim, HIDDEN), mm, dev)
    _check_mat("W2", W2, _hidden_shape(mm), mm, dev)
    _check_mat("W3", W3, _hidden_shape(mm), mm, dev)
    _check_mat("W4", W4, (HIDDEN, Fdim), mm, dev)
    _check_mat("Ws", Ws, (HIDDEN, Fdim), mm, dev)
    ptr = lambda t: t.data_ptr()
    if bf16:  # every step's (gamma, gamma * bias) pairs in one table
        _check_mat("gates", gammas_tables, (n_steps, 3, HIDDEN // 2, 4), torch.float32, dev)
        tables = (None, None, None, ptr(gammas_tables))
    else:
        E = tuple(e.float().contiguous() for e in gammas_tables)
        for name, e in zip(("E1", "E2", "E3"), E):
            _check_mat(name, e, (n_steps, HIDDEN), torch.float32, dev)
        tables = tuple(ptr(e) for e in E) + (None,)
    out = torch.empty((M, Fdim), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.upgdm_chain_resident(
        ptr(y0h), ptr(gx), M, Fdim, n_steps, ptr(tab), int(seed) & (2**64 - 1),
        int(noise_mode == "prng"), int(bool(use_gx_directly)), *tables,
        ptr(W1), ptr(b1), ptr(W2), ptr(b2), ptr(W3), ptr(b3), ptr(W4), ptr(b4), ptr(Ws),
        ptr(bs), ptr(out), int(bf16), stream,
    )
    _build.check(code, "chain_resident")
    fused_chain_rows.launches += 1
    return out


fused_chain_rows.launches = 0


def fused_nsdiff_chain(denoiser, y0_hat, gx, sched, seed, n_z_samples: int,
                       matmul_dtype="bfloat16", act_dtype="float32",
                       noise_mode="prng", use_gx_directly=False):
    """Chain-resident ensemble sampler: [B, O, N] y0_hat/gx -> samples
    [B, O, N, S] (the JAX package's ``fused_nsdiff_chain`` signature, with
    the denoiser module in place of its flax params)."""
    B, O, N = y0_hat.shape
    S = n_z_samples
    y0_rows = y0_hat.float()[None].expand(S, B, O, N).reshape(-1, N).contiguous()
    gx_rows = gx.float()[None].expand(S, B, O, N).reshape(-1, N).contiguous()
    d = denoiser
    tables = tuple(e.detach() for e in (d.lin1.embed, d.lin2.embed, d.lin3.embed))
    out = fused_chain_rows(
        y0_rows, gx_rows, schedule_table(sched), seed, tables, denoiser_weights(d),
        sched.num_timesteps, matmul_dtype=matmul_dtype, act_dtype=act_dtype,
        noise_mode=noise_mode, use_gx_directly=use_gx_directly,
    )
    return out.reshape(S, B, O, N).permute(1, 2, 3, 0)
