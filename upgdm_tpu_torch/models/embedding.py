"""Token + positional embedding of the NS-Transformer.

Counterpart of ``DataEmbedding`` in ``upgdm_tpu/models/embedding.py``: a
circular Conv1d (k=3, no bias) over time plus the fixed sin/cos position
table, then dropout (active only when a generator is passed).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout

__all__ = ["positional_encoding_table", "CircularConv1d", "TokenEmbedding", "DataEmbedding"]


def positional_encoding_table(max_len: int, d_model: int) -> np.ndarray:
    """Fixed sin/cos position table [max_len, d_model] (Informer-family)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return pe


class CircularConv1d(nn.Module):
    """Conv over the time axis with circular padding; input/output [B, T, C]."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.pad = kernel_size // 2
        self.Conv_0 = nn.Conv1d(in_features, features, kernel_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (self.pad, self.pad), mode="circular")
        return self.Conv_0(x).transpose(1, 2)


class TokenEmbedding(nn.Module):
    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.CircularConv1d_0 = CircularConv1d(c_in, d_model, kernel_size=3)

    def forward(self, x):
        return self.CircularConv1d_0(x)


class DataEmbedding(nn.Module):
    """Token conv + fixed positional table, then dropout ([B, T, c_in] -> [B, T, d])."""

    def __init__(self, c_in: int, d_model: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        self.TokenEmbedding_0 = TokenEmbedding(c_in, d_model)
        self.dropout = Dropout(dropout)
        self.register_buffer(
            "pe", torch.from_numpy(positional_encoding_table(max_len, d_model)),
            persistent=False,
        )

    def forward(self, x, gen=None):
        out = self.TokenEmbedding_0(x) + self.pe[: x.shape[1]].to(x.dtype)[None]
        return self.dropout(out, gen)
