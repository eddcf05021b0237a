"""Trailing rolling-window population variance.

Counterpart of ``upgdm_tpu/ops/rolling.py::wv_sigma_trailing``: the series is
replicate-padded by ``window - 1`` at the front, window sums are taken in
order, and the variance is E[x^2] - E[x]^2 clamped at 0 (the clamp
guards the tiny negative residue of the difference-of-means form).
"""
from __future__ import annotations

import torch

__all__ = ["wv_sigma_trailing"]


def _window_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean over each length-`window` slice along axis 1 (valid windows only).

    x: [B, T, N] -> [B, T - window + 1, N]. The window is summed in order,
    as ``lax.reduce_window`` does, because E[x^2] - E[x]^2 cancels and a
    different summation order shows in the result's low digits.
    """
    n = x.shape[1] - window + 1
    acc = x[:, 0:n]
    for i in range(1, window):
        acc = acc + x[:, i : i + n]
    return acc * (1.0 / window)


def _window_var(x: torch.Tensor, window: int) -> torch.Tensor:
    mean = _window_mean(x, window)
    mean_sq = _window_mean(x * x, window)
    return torch.clamp(mean_sq - mean * mean, min=0.0)


def wv_sigma_trailing(
    x_enc: torch.Tensor, window_size: int, discard_rep: bool = False
) -> torch.Tensor:
    """Trailing-window population variance of x_enc [B, T, N].

    ``discard_rep=False`` replicate-pads ``window_size - 1`` steps at the
    front so the output has length T; ``discard_rep=True`` returns only the
    T - window + 1 valid windows.
    """
    if discard_rep:
        return _window_var(x_enc, window_size)
    pad = x_enc[:, :1, :].expand(-1, window_size - 1, -1)
    return _window_var(torch.cat([pad, x_enc], dim=1), window_size)
