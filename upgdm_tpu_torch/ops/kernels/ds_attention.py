"""The NS-Transformer's de-stationary attention (wrapper of
``csrc/ds_attention.cu``) and its plain twin.

A port kernel with no Pallas site: the JAX package leaves this attention to
XLA (``upgdm_tpu/models/attention.py::DSAttention``). For queries
[B, L, H, E] and keys and values [B, S, H, E], tau [B, 1] or None and delta
[B, S] or None:

    scores = (q . k) * tau + delta, keys after the query filled with -1e9
             when causal, times 1 / sqrt(E)
    out    = softmax(scores) . v                      [B, L, H, E]

``ds_attention_reference`` is that arithmetic as plain PyTorch, the CPU
path and the tests' reference. On the card ``ds_attention`` runs the twin
only for the calls the kernel leaves to it by design (``kernel_unfit``: a
gradient wanted, dropout, tensors not float32: the train step and bf16
backbones), counted in the program counter ``ds_attention.fallbacks``, and
launches the kernel on the current stream for every other call, counted in
``ds_attention.launches``. It raises for a call the kernel cannot take: a
head width not in ``BUILT_E``, more keys than ``max_keys`` (the kernel's
score rows in shared memory), shapes or devices that disagree. The kernel
reads q, k and v in place (a layout whose rows are not 16-byte aligned is
copied first) and writes a contiguous [B, L, H, E].
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ...utils.profiling import count
from . import _build

__all__ = ["BUILT_E", "ds_attention", "ds_attention_reference", "kernel_unfit", "max_keys"]

_NEG_INF = -1e9
BUILT_E = (8, 16, 32, 64)  # head widths the kernel is built for


def ds_attention_reference(queries, keys, values, tau=None, delta=None, causal=False,
                           drop: Optional[Callable] = None):
    """Plain PyTorch twin; ``drop`` (dropout) is applied to the weights."""
    B, L, H, E = queries.shape
    scale = 1.0 / math.sqrt(E)
    scores = torch.einsum("blhe,bshe->bhls", queries, keys)
    if tau is not None:
        scores = scores * tau[:, :, None, None]
    if delta is not None:
        scores = scores + delta[:, None, None, :]
    if causal:
        S = scores.shape[-1]
        mask = torch.ones(L, S, dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~mask, _NEG_INF)
    attn = torch.softmax(scale * scores, dim=-1)
    if drop is not None:
        attn = drop(attn)
    return torch.einsum("bhls,bshd->blhd", attn, values)


def kernel_unfit(queries, keys, values, tau=None, delta=None, dropout=False) -> Optional[str]:
    """Why the twin runs this call by design ("dropout", "gradient",
    "dtype"), or None: the kernel takes it."""
    named = [t for t in (queries, keys, values, tau, delta) if t is not None]
    if dropout:
        return "dropout"
    if torch.is_grad_enabled() and any(t.requires_grad for t in named):
        return "gradient"
    if any(t.dtype != torch.float32 for t in named):
        return "dtype"
    return None


@functools.lru_cache(maxsize=None)
def max_keys(E: int) -> int:
    """The most keys a call at head width E takes on the current card."""
    return _build.load_library().upgdm_ds_attention_max_keys(E)


def _check(queries, keys, values, tau, delta):
    """Raise for a call the kernel cannot take."""
    B, L, H, E = queries.shape
    S = keys.shape[1]
    if (keys.shape != (B, S, H, E) or values.shape != keys.shape
            or (tau is not None and tuple(tau.shape) != (B, 1))
            or (delta is not None and tuple(delta.shape) != (B, S))):
        raise ValueError(
            f"ds_attention: shapes disagree: q {tuple(queries.shape)}, k {tuple(keys.shape)}, "
            f"v {tuple(values.shape)}, tau {None if tau is None else tuple(tau.shape)}, "
            f"delta {None if delta is None else tuple(delta.shape)}")
    if any(t is not None and t.device != queries.device for t in (keys, values, tau, delta)):
        raise ValueError("ds_attention: q, k, v, tau and delta are not on one device")
    if E not in BUILT_E:
        raise ValueError(f"ds_attention: head width {E} is not one the kernel is built for "
                         f"{BUILT_E}; DSAttention.use_kernel = False runs the plain twin")
    if S > max_keys(E):
        raise ValueError(f"ds_attention: {S} keys, more than the {max_keys(E)} the kernel "
                         f"takes at head width {E}; DSAttention.use_kernel = False runs the "
                         f"plain twin")


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _rows_fit(t) -> bool:
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _launch(queries, keys, values, tau, delta, causal):
    B, L, H, E = queries.shape
    S = keys.shape[1]
    out = torch.empty(B, L, H, E, dtype=torch.float32, device=queries.device)
    strides = np.array([*queries.stride()[:3], *keys.stride()[:3], *values.stride()[:3],
                        0 if tau is None else tau.stride(0),
                        0 if delta is None else delta.stride(0)], dtype=np.int64)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _build.load_library().upgdm_ds_attention(
        queries.data_ptr(), keys.data_ptr(), values.data_ptr(), ptr(tau), ptr(delta),
        out.data_ptr(), strides.ctypes.data, B, H, L, S, E, int(bool(causal)),
        ctypes.c_float(1.0 / math.sqrt(E)),
        torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(code, "ds_attention")
    return out


def ds_attention(queries, keys, values, tau=None, delta=None, causal=False,
                 drop: Optional[Callable] = None, use_kernel: bool = True):
    """The attention of ``ds_attention_reference``: on the card the kernel,
    unless ``kernel_unfit`` gives a reason or ``use_kernel`` is False (the
    twin, counted as a fallback); CPU tensors run the twin."""
    if not _on_card(queries):
        return ds_attention_reference(queries, keys, values, tau, delta, causal, drop)
    if not use_kernel or kernel_unfit(queries, keys, values, tau, delta, drop is not None):
        count("ds_attention.fallbacks")
        return ds_attention_reference(queries, keys, values, tau, delta, causal, drop)
    _check(queries, keys, values, tau, delta)
    B, L, H, E = queries.shape
    if B * L * H == 0 or keys.shape[1] == 0:  # nothing to launch: the twin's zeros
        return queries.new_zeros(B, L, H, E)
    queries, keys, values = (t if _rows_fit(t) else t.clone(memory_format=torch.contiguous_format)
                             for t in (queries, keys, values))
    if delta is not None and delta.stride(1) != 1:
        delta = delta.contiguous()
    out = _launch(queries, keys, values, tau, delta, causal)
    count("ds_attention.launches")
    return out
