"""NsDiff variance head g(x).

Counterpart of ``upgdm_tpu/models/sigma_estimation.py``: trailing window
variance of the history -> 3-layer MLP with LayerNorm over the
[enc_in, hidden] plane -> softplus future sigma per (pred_len, F).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rolling import wv_sigma_trailing

__all__ = ["SigmaEstimation", "LN_EPS"]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


class SigmaEstimation(nn.Module):
    def __init__(self, seq_len: int, pred_len: int, enc_in: int,
                 hidden_size: int = 512, kernel_size: int = 24):
        super().__init__()
        self.pred_len = pred_len
        self.kernel_size = kernel_size
        self.Dense_0 = nn.Linear(seq_len - kernel_size, hidden_size)
        # torch LayerNorm([enc_in, hidden]): normalise AND affine over both dims
        self.LayerNorm_0 = nn.LayerNorm([enc_in, hidden_size], eps=LN_EPS)
        self.Dense_1 = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm_1 = nn.LayerNorm([enc_in, hidden_size], eps=LN_EPS)
        self.Dense_2 = nn.Linear(hidden_size, pred_len)

    def forward(self, x_enc: torch.Tensor) -> torch.Tensor:
        # x_enc: [B, T, N] -> sigma forecast [B, pred_len, N]
        T = x_enc.shape[1]
        sigma = wv_sigma_trailing(x_enc, self.kernel_size, discard_rep=False)
        sigma = sigma[:, -(T - self.kernel_size):, :] + 10e-8
        h = sigma.transpose(1, 2)  # [B, N, T - kernel]
        h = self.LayerNorm_0(F.relu(self.Dense_0(h)))
        h = self.LayerNorm_1(F.relu(self.Dense_1(h)))
        h = self.Dense_2(h)
        pred_sigma = F.softplus(h).transpose(1, 2)  # [B, pred_len, N]
        return pred_sigma[:, -self.pred_len:, :]
