"""De-stationary attention of the NS-Transformer, and DiffusionTS's plain
full and cross attention.

Counterpart of ``upgdm_tpu/models/attention.py``: in ``DSAttention`` tau
rescales the scores and delta shifts them before the softmax; the causal
mask fills with -1e9. ``FullAttention``/``CrossAttention``
(diffusionts_transformer.py:123-201) are q @ k^T / sqrt(d), a softmax and
the projection, returning the output and the head-averaged attention map.
Dropout on the attention weights is active only when a generator is passed.
``DSAttention`` runs ``ops/kernels/ds_attention.py``: on the card one
hand-written kernel a float32 call with no gradient wanted and no dropout
(sampling); the train step, bf16 backbones and the CPU run its plain twin,
matmul + softmax as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels.ds_attention import ds_attention
from .dropout import Dropout
from .layers import Linear

__all__ = ["DSAttention", "AttentionLayer", "FullAttention", "CrossAttention"]

_NEG_INF = -1e9


class DSAttention(nn.Module):
    """q, k, v: [B, L, H, E]; tau: [B, 1] or None; delta: [B, S] or None.

    ``use_kernel`` False runs the plain twin on the card too (a test seam)."""

    def __init__(self, mask_flag: bool = False, attention_dropout: float = 0.05):
        super().__init__()
        self.mask_flag = mask_flag
        self.dropout = Dropout(attention_dropout)
        self.use_kernel = True

    def forward(self, queries, keys, values, tau=None, delta=None, gen=None):
        drop = None
        if gen is not None and self.dropout.rate > 0.0:
            drop = lambda attn: self.dropout(attn, gen)
        return ds_attention(queries, keys, values, tau, delta, self.mask_flag, drop,
                            self.use_kernel)


class AttentionLayer(nn.Module):
    """Multi-head projection wrapper around DSAttention."""

    def __init__(self, d_model: int, n_heads: int, mask_flag: bool = False,
                 attention_dropout: float = 0.05):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)
        self.inner = DSAttention(mask_flag, attention_dropout)

    def forward(self, queries, keys, values, tau=None, delta=None, gen=None):
        B, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        d_head = self.d_model // H
        q = self.query(queries).reshape(B, L, H, d_head)
        k = self.key(keys).reshape(B, S, H, d_head)
        v = self.value(values).reshape(B, S, H, d_head)
        out = self.inner(q, k, v, tau=tau, delta=delta, gen=gen).reshape(B, L, self.d_model)
        return self.out(out)


class CrossAttention(nn.Module):
    """Multi-head attention from x [B, T, C] to a condition [B, T_E, C_E]:
    (y [B, T, C], attention [B, T, T_E] averaged over the heads)."""

    def __init__(self, n_embd: int, condition_embd: int, n_head: int, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_embd, n_embd)
        self.key = Linear(condition_embd, n_embd)
        self.value = Linear(condition_embd, n_embd)
        self.proj = Linear(n_embd, n_embd)
        self.attn_drop = Dropout(attn_pdrop)
        self.resid_drop = Dropout(resid_pdrop)

    def forward(self, x, cond, mask=None, gen=None):
        B, T, C = x.shape
        H = self.n_head
        d = C // H
        heads = lambda h: h.reshape(B, h.shape[1], H, d).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(cond)), heads(self.value(cond))
        att = (q @ k.transpose(-2, -1)) / math.sqrt(d)
        if mask is not None:
            att = att.masked_fill(~mask[:, None, None, :], _NEG_INF)
        att = self.attn_drop(torch.softmax(att, dim=-1), gen)
        y = (att @ v).transpose(1, 2).reshape(B, T, C)
        return self.resid_drop(self.proj(y), gen), att.mean(dim=1)


class FullAttention(CrossAttention):
    """Multi-head self-attention of x [B, T, C]."""

    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1):
        super().__init__(n_embd, n_embd, n_head, attn_pdrop, resid_pdrop)

    def forward(self, x, mask=None, gen=None):
        return super().forward(x, x, mask, gen)
