"""De-stationary attention of the NS-Transformer.

Counterpart of ``DSAttention`` and ``AttentionLayer`` in
``upgdm_tpu/models/attention.py``: tau rescales the scores and delta shifts
them before the softmax; the causal mask fills with -1e9; dropout on the
attention weights is active only when a generator is passed. Written as
plain matmul + softmax, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .dropout import Dropout
from .layers import Linear

__all__ = ["DSAttention", "AttentionLayer"]

_NEG_INF = -1e9


class DSAttention(nn.Module):
    """q, k, v: [B, L, H, E]; tau: [B, 1] or None; delta: [B, S] or None."""

    def __init__(self, mask_flag: bool = False, attention_dropout: float = 0.05):
        super().__init__()
        self.mask_flag = mask_flag
        self.dropout = Dropout(attention_dropout)

    def forward(self, queries, keys, values, tau=None, delta=None, gen=None):
        B, L, H, E = queries.shape
        scale = 1.0 / math.sqrt(E)
        scores = torch.einsum("blhe,bshe->bhls", queries, keys)
        if tau is not None:
            scores = scores * tau[:, :, None, None]
        if delta is not None:
            scores = scores + delta[:, None, None, :]
        if self.mask_flag:
            S = scores.shape[-1]
            causal = torch.ones(L, S, dtype=torch.bool, device=scores.device).tril()
            scores = scores.masked_fill(~causal, _NEG_INF)
        attn = self.dropout(torch.softmax(scale * scores, dim=-1), gen)
        return torch.einsum("bhls,bshd->blhd", attn, values)


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
