"""Conditional MLP denoiser of NsDiff (the plain version).

Counterpart of ``ConditionalLinear`` and ``NsDiffDenoiser`` in
``upgdm_tpu/models/denoise.py``: three ConditionalLinear(128) layers with
per-step embedding gates on concat(y_t, y0_hat, gx), L2-normalised between
layers; an eps head and a softplus sigma head that reads softplus(h).

On the card the sampler runs this computation through the hand-written
kernel in ``ops/kernels/fused_denoiser.py``; this module is what the CPU
path and the tests run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ConditionalLinear", "NsDiffDenoiser", "HIDDEN"]

HIDDEN = 128


class ConditionalLinear(nn.Module):
    """Dense whose output is gated by a learned per-timestep embedding row."""

    def __init__(self, num_in: int, num_out: int, n_steps: int):
        super().__init__()
        self.Dense_0 = nn.Linear(num_in, num_out)
        self.embed = nn.Parameter(torch.rand(n_steps, num_out))  # U(0, 1) as flax

    def forward(self, x, t):
        out = self.Dense_0(x)
        gamma = self.embed[t]  # [B, num_out] or [num_out]
        while gamma.ndim < out.ndim:
            gamma = gamma.unsqueeze(-2)
        return gamma * out


def _l2_normalize(x, eps=1e-12):
    # torch F.normalize semantics: x / max(||x||_2, eps)
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=eps)


class NsDiffDenoiser(nn.Module):
    """(y_t, y0_hat, gx, t) -> (eps_pred, sigma_pred), each [..., O, N]."""

    def __init__(self, enc_in: int, n_steps: int, hidden: int = HIDDEN):
        super().__init__()
        self.lin1 = ConditionalLinear(3 * enc_in, hidden, n_steps)
        self.lin2 = ConditionalLinear(hidden, hidden, n_steps)
        self.lin3 = ConditionalLinear(hidden, hidden, n_steps)
        self.lin4 = nn.Linear(hidden, enc_in)
        self.sigma_lin = nn.Linear(hidden, enc_in)

    def forward(self, y_t, y_0_hat, g_x, t):
        h = torch.cat([y_t, y_0_hat, g_x], dim=-1)
        h = _l2_normalize(F.softplus(self.lin1(h, t)))
        h = _l2_normalize(F.softplus(self.lin2(h, t)))
        h = _l2_normalize(F.softplus(self.lin3(h, t)))
        eps_pred = self.lin4(h)
        sigma = F.softplus(self.sigma_lin(F.softplus(h)))
        return eps_pred, sigma
