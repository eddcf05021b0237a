"""De-stationary attention of the NS-Transformer, and DiffusionTS's plain
full and cross attention.

Counterpart of ``upgdm_tpu/models/attention.py``: in ``DSAttention`` tau
rescales the scores and delta shifts them before the softmax; the causal
mask fills with -1e9. ``FullAttention``/``CrossAttention``
(diffusionts_transformer.py:123-201) are q @ k^T / sqrt(d), a softmax and
the projection, returning the output and the head-averaged attention map.
Dropout on the attention weights is active only when a generator is passed.
Written as plain matmul + softmax, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .dropout import Dropout
from .layers import Linear

__all__ = ["DSAttention", "AttentionLayer", "FullAttention", "CrossAttention"]

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
