"""The NsDiff and CARD (TMDM) noise schedules, restated in numpy.

Both start from the linear betas of the reference configurations
(``beta_start`` to ``beta_end`` over ``diffusion_steps``) and are built in
float64. NsDiff's cumulants are written as the sums that define them:

    alpha_tilde[t] = sum_k prod_{j=k..t} alpha_j
    alpha_hat[t]   = sum_k alpha_k * prod_{j=k..t} alpha_j

and ``betas_tilde = alpha_tilde - alpha_hat``, ``betas_bar = 1 - alphas_cumprod``
(NsDiff, "Non-stationary Diffusion for Probabilistic Time Series
Forecasting", the heteroscedastic forward process). The tables are float64;
the reference takes its per-step scalars from them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["NsDiffTables", "nsdiff_tables", "CardTables", "card_tables"]


def _linear_betas(steps: int, start: float, end: float) -> np.ndarray:
    return np.linspace(start, end, int(steps), dtype=np.float64)


@dataclass(frozen=True)
class NsDiffTables:
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    betas_bar: np.ndarray
    betas_tilde: np.ndarray
    betas_bar_prev: np.ndarray  # entry t holds betas_bar[t-1]; entry 0 is 1
    betas_tilde_prev: np.ndarray  # the same for betas_tilde

    @property
    def steps(self) -> int:
        return int(self.alphas.shape[0])


def nsdiff_tables(steps: int, start: float, end: float) -> NsDiffTables:
    a = 1.0 - _linear_betas(steps, start, end)
    T = a.shape[0]
    tilde = np.zeros(T)
    hat = np.zeros(T)
    for t in range(T):
        for k in range(t + 1):
            p = np.prod(a[k:t + 1])
            tilde[t] += p
            hat[t] += a[k] * p
    acp = np.cumprod(a)
    betas_bar = 1.0 - acp
    betas_tilde = np.clip(tilde - hat, 0.0, None)
    one = np.ones(1)
    return NsDiffTables(
        alphas=a,
        alphas_cumprod=acp,
        alphas_cumprod_prev=np.concatenate([one, acp[:-1]]),
        betas_bar=betas_bar,
        betas_tilde=betas_tilde,
        betas_bar_prev=np.concatenate([one, betas_bar[:-1]]),
        betas_tilde_prev=np.concatenate([one, betas_tilde[:-1]]),
    )


@dataclass(frozen=True)
class CardTables:
    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray

    @property
    def steps(self) -> int:
        return int(self.alphas.shape[0])


def card_tables(steps: int, start: float, end: float) -> CardTables:
    betas = _linear_betas(steps, start, end)
    a = 1.0 - betas
    acp = np.cumprod(a)
    return CardTables(betas=betas, alphas=a, alphas_cumprod=acp,
                      alphas_cumprod_prev=np.concatenate([np.ones(1), acp[:-1]]))
