"""Rolling-window population variance.

Counterpart of ``upgdm_tpu/ops/rolling.py``: ``wv_sigma`` (the centred
window, replicate-padded), ``wv_sigma_trailing`` (the trailing window) and
``window_variance_1d`` (strided valid windows of a 1-D series, the
raw-window-variance control of the SLBP analyses). Window sums are taken in
order and the variance is E[x^2] - E[x]^2 clamped at 0 (the clamp guards the
tiny negative residue of the difference-of-means form).
"""
from __future__ import annotations

import torch

__all__ = ["wv_sigma", "wv_sigma_trailing", "window_variance_1d"]


def _window_mean(x: torch.Tensor, window: int, step: int = 1) -> torch.Tensor:
    """Mean over each length-`window` slice along axis 1 (valid windows only,
    starts ``step`` apart).

    x: [B, T, N] -> [B, (T - window) // step + 1, N]. The window is summed in
    order, as ``lax.reduce_window`` does, because E[x^2] - E[x]^2 cancels and
    a different summation order shows in the result's low digits.
    """
    n = (x.shape[1] - window) // step + 1
    if n <= 0:
        return x[:, :0]
    span = (n - 1) * step + 1
    acc = x[:, 0:span:step]
    for i in range(1, window):
        acc = acc + x[:, i : i + span : step]
    return acc * (1.0 / window)


def _window_var(x: torch.Tensor, window: int, step: int = 1) -> torch.Tensor:
    mean = _window_mean(x, window, step)
    mean_sq = _window_mean(x * x, window, step)
    return torch.clamp(mean_sq - mean * mean, min=0.0)


def _replicate_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    parts = [x[:, :1, :].expand(-1, left, -1), x]
    if right > 0:
        parts.append(x[:, -1:, :].expand(-1, right, -1))
    return torch.cat(parts, dim=1)


def wv_sigma(x_enc: torch.Tensor, window_size: int) -> torch.Tensor:
    """Centred sliding-window population variance of x_enc [B, T, N], same
    length as the input. An even window pads one step more on the left."""
    if window_size % 2 == 0:
        left, right = window_size // 2, window_size // 2 - 1
    else:
        left = right = window_size // 2
    return _window_var(_replicate_pad(x_enc, left, right), window_size)


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
    return _window_var(_replicate_pad(x_enc, window_size - 1, 0), window_size)


def window_variance_1d(series: torch.Tensor, windows: int, step: int) -> torch.Tensor:
    """Population variance of the valid windows of a 1-D series that start
    ``step`` apart: [T] -> [(T - windows) // step + 1]."""
    return _window_var(series[None, :, None], windows, step)[0, :, 0]
