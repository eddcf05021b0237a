"""Conditional MLP denoisers of NsDiff and TMDM (the plain versions).

Counterpart of ``upgdm_tpu/models/denoise.py``:

  - ``NsDiffDenoiser``: three ConditionalLinear(128) layers with per-step
    embedding gates on concat(y_t, y0_hat, gx), L2-normalised between
    layers; an eps head and a softplus sigma head that reads softplus(h);
  - ``TMDMDenoiser``: the same gating on concat(y_t, y0_hat) (or
    concat(y_t, x_emb), or y_t alone), no normalisation, one eps head.

On the card the samplers run these computations through the hand-written
kernels in ``ops/kernels/fused_denoiser.py`` and ``ops/kernels/fused_tmdm.py``;
these modules are what the CPU path and the tests run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear

__all__ = ["ConditionalLinear", "NsDiffDenoiser", "TMDMDenoiser", "HIDDEN"]

HIDDEN = 128


class ConditionalLinear(nn.Module):
    """Dense whose output is gated by a learned per-timestep embedding row."""

    def __init__(self, num_in: int, num_out: int, n_steps: int):
        super().__init__()
        self.Dense_0 = Linear(num_in, num_out)
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
        self.lin4 = Linear(hidden, enc_in)
        self.sigma_lin = Linear(hidden, enc_in)

    def forward(self, y_t, y_0_hat, g_x, t):
        h = torch.cat([y_t, y_0_hat, g_x], dim=-1)
        h = _l2_normalize(F.softplus(self.lin1(h, t)))
        h = _l2_normalize(F.softplus(self.lin2(h, t)))
        h = _l2_normalize(F.softplus(self.lin3(h, t)))
        eps_pred = self.lin4(h)
        sigma = F.softplus(self.sigma_lin(F.softplus(h)))
        return eps_pred, sigma


class TMDMDenoiser(nn.Module):
    """(x_emb, y_t, y_0_hat, t) -> eps_pred [..., O, N].

    ``cat_y_pred`` reads concat(y_t, y0_hat) (the layout of every TMDM
    config); otherwise ``cat_x`` reads concat(y_t, x_emb) with x_emb
    ``x_dim`` wide, and with neither the input is y_t alone. ``n_steps`` is
    the number of diffusion steps plus one (tmdm_model.py:26).
    """

    def __init__(self, enc_in: int, n_steps: int, hidden: int = HIDDEN, cat_x: bool = True,
                 cat_y_pred: bool = True, x_dim: int = 0):
        super().__init__()
        self.cat_x, self.cat_y_pred = cat_x, cat_y_pred
        if cat_y_pred:
            in_dim = 2 * enc_in
        elif cat_x:
            in_dim = enc_in + x_dim
        else:
            in_dim = enc_in
        self.lin1 = ConditionalLinear(in_dim, hidden, n_steps)
        self.lin2 = ConditionalLinear(hidden, hidden, n_steps)
        self.lin3 = ConditionalLinear(hidden, hidden, n_steps)
        self.lin4 = Linear(hidden, enc_in)

    def forward(self, x_emb, y_t, y_0_hat, t):
        if self.cat_y_pred:
            h = torch.cat([y_t, y_0_hat], dim=-1)
        elif self.cat_x:
            h = torch.cat([y_t, x_emb], dim=-1)
        else:
            h = y_t
        h = F.softplus(self.lin1(h, t))
        h = F.softplus(self.lin2(h, t))
        h = F.softplus(self.lin3(h, t))
        return self.lin4(h)
