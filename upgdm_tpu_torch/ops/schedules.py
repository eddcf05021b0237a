"""NsDiff, CARD (TMDM), DiffusionTS and DiffSTG noise schedules (numpy, host
side).

Counterpart of ``upgdm_tpu/ops/schedules.py``:
the same float64 construction, stored as float32, so every array equals the
JAX package's bit for bit. A schedule is static per configuration; the
samplers gather per-step scalars from it.

The reference's O(T^2) cumulant loops (NsDiff_net.py:22-54) are computed as
the equivalent O(T) linear recurrences:
    tilde[t]   = a[t] * (1 + tilde[t-1])
    hat[t]     = a[t]^2 + a[t] * hat[t-1]
    gx_term[t] = (1 - a[t])^2 + a[t] * gx_term[t-1]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

__all__ = ["make_beta_schedule", "nsdiff_cumulants", "NsDiffSchedule", "CardSchedule",
           "card_schedule", "DiffusionTSSchedule", "diffusionts_schedule", "DiffSTGSchedule",
           "diffstg_schedule", "inference_time_pairs", "ddim_time_pairs"]


def make_beta_schedule(
    schedule: str = "linear",
    num_timesteps: int = 1000,
    start: float = 1e-5,
    end: float = 1e-2,
) -> np.ndarray:
    """All seven beta schedules of the reference, in float64."""
    T = int(num_timesteps)
    if schedule == "linear":
        betas = np.linspace(start, end, T)
    elif schedule == "const":
        betas = end * np.ones(T)
    elif schedule == "quad":
        betas = np.linspace(start ** 0.5, end ** 0.5, T) ** 2
    elif schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T)
    elif schedule == "sigmoid":
        x = np.linspace(-6.0, 6.0, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (end - start) + start
    elif schedule in ("cosine", "cosine_reverse"):
        max_beta = 0.999
        s = 0.008

        def f(i):
            return math.cos((i / T + s) / (1 + s) * math.pi / 2) ** 2

        betas = np.array([min(1 - f(i + 1) / f(i), max_beta) for i in range(T)])
        if schedule == "cosine_reverse":
            betas = betas[::-1].copy()
    elif schedule == "cosine_anneal":
        betas = np.array(
            [
                start + 0.5 * (end - start) * (1 - math.cos(t / (T - 1) * math.pi))
                for t in range(T)
            ]
        )
    else:
        raise ValueError(f"unknown beta schedule: {schedule!r}")
    return np.asarray(betas, dtype=np.float64)


def _linear_recurrence(add: np.ndarray, mul: np.ndarray) -> np.ndarray:
    """x[t] = add[t] + mul[t] * x[t-1], x[-1] = 0 (float64, tiny T)."""
    out = np.empty_like(add)
    acc = 0.0
    for t in range(add.shape[0]):
        acc = add[t] + mul[t] * acc
        out[t] = acc
    return out


def nsdiff_cumulants(alphas: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(alpha_tilde, alpha_hat, gx_term) computed O(T)."""
    a = np.asarray(alphas, dtype=np.float64)
    tilde = _linear_recurrence(a, a)
    hat = _linear_recurrence(a * a, a)
    gx = _linear_recurrence((1.0 - a) ** 2, a)
    return tilde, hat, gx


@dataclasses.dataclass(frozen=True)
class NsDiffSchedule:
    """Frozen NsDiff schedule (all float32 ndarray, length T); field names
    follow NsDiff_net (NsDiff_net.py:92-134)."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_bar_sqrt: np.ndarray
    one_minus_alphas_bar_sqrt: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_sum: np.ndarray  # = alpha_tilde
    alphas_cumprod_sum_prev: np.ndarray
    alphas_hat: np.ndarray
    betas_bar: np.ndarray
    betas_tilde: np.ndarray
    betas_tilde_m_1: np.ndarray
    betas_bar_m_1: np.ndarray
    gx_term: np.ndarray
    posterior_variance: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @staticmethod
    def create(
        schedule: str = "linear",
        num_timesteps: int = 100,
        beta_start: float = 1e-4,
        beta_end: float = 2e-2,
    ) -> "NsDiffSchedule":
        betas = make_beta_schedule(schedule, num_timesteps, beta_start, beta_end)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        tilde, hat, gx_term = nsdiff_cumulants(alphas)
        betas_bar = 1.0 - acp
        betas_tilde = tilde - hat
        if not (betas_tilde >= -1e-12).all():
            raise ValueError("betas_tilde must be non-negative")
        if not ((betas_bar - betas_tilde) >= -1e-12).all():
            raise ValueError("betas_bar must dominate betas_tilde")
        betas_tilde = np.clip(betas_tilde, 0.0, None)

        one_minus_abar_sqrt = np.sqrt(1.0 - acp)
        if schedule == "cosine":
            # avoid div-by-0 for 1/sqrt(alpha_bar) at inference (NsDiff_net.py:127-128)
            one_minus_abar_sqrt = one_minus_abar_sqrt * 0.9999
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        tilde_prev = np.concatenate([[1.0], tilde[:-1]])
        betas_tilde_m_1 = np.concatenate([[1.0], betas_tilde[:-1]])
        betas_bar_m_1 = np.concatenate([[1.0], betas_bar[:-1]])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)

        f32 = lambda x: np.asarray(x, dtype=np.float32)
        return NsDiffSchedule(
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_cumprod=f32(acp),
            alphas_bar_sqrt=f32(np.sqrt(acp)),
            one_minus_alphas_bar_sqrt=f32(one_minus_abar_sqrt),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_sum=f32(tilde),
            alphas_cumprod_sum_prev=f32(tilde_prev),
            alphas_hat=f32(hat),
            betas_bar=f32(betas_bar),
            betas_tilde=f32(betas_tilde),
            betas_tilde_m_1=f32(betas_tilde_m_1),
            betas_bar_m_1=f32(betas_bar_m_1),
            gx_term=f32(gx_term),
            posterior_variance=f32(posterior_variance),
        )


@dataclasses.dataclass(frozen=True)
class CardSchedule:
    """Frozen CARD schedule of TMDM (all float32 ndarray, length T)."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_bar_sqrt: np.ndarray
    one_minus_alphas_bar_sqrt: np.ndarray
    alphas_cumprod_prev: np.ndarray
    posterior_variance: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def card_schedule(
    schedule: str = "linear",
    num_timesteps: int = 100,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
) -> CardSchedule:
    """Schedule used by TMDM (TMDM.py:52-77)."""
    betas = make_beta_schedule(schedule, num_timesteps, beta_start, beta_end)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    one_minus_abar_sqrt = np.sqrt(1.0 - acp)
    if schedule == "cosine":
        one_minus_abar_sqrt = one_minus_abar_sqrt * 0.9999
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return CardSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(acp),
        alphas_bar_sqrt=f32(np.sqrt(acp)),
        one_minus_alphas_bar_sqrt=f32(one_minus_abar_sqrt),
        alphas_cumprod_prev=f32(acp_prev),
        posterior_variance=f32(posterior_variance),
    )


# ---------------------------------------------------------------------------
# DiffusionTS schedule (DiffusionTS.py:15-32, 96-124)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffusionTSSchedule:
    """Frozen DiffusionTS schedule (all float32 ndarray, length T)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    loss_weight: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def diffusionts_schedule(beta_schedule: str = "cosine", timesteps: int = 100
                         ) -> DiffusionTSSchedule:
    """The linear or cosine betas and every derived table, in float64."""
    if beta_schedule == "linear":
        scale = 1000.0 / timesteps
        betas = np.linspace(scale * 1e-4, scale * 2e-2, timesteps, dtype=np.float64)
    elif beta_schedule == "cosine":
        s = 0.008
        steps = timesteps + 1
        x = np.linspace(0, timesteps, steps, dtype=np.float64)
        ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        betas = np.clip(1 - (ac[1:] / ac[:-1]), 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")

    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionTSSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        loss_weight=f32(np.sqrt(alphas) * np.sqrt(1.0 - acp) / betas / 100.0),
    )


# ---------------------------------------------------------------------------
# DiffSTG schedule (diffusion_schedulers.py:39-125)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffSTGSchedule:
    """The reference's 1-indexed convention: ``alpha`` has length T+1 with
    alpha[0] = 1 and ``alphabar[t]`` = prod_{i<=t} alpha[i]; ``beta`` has
    length T (diffusion_schedulers.py:62-64). Timesteps t run in 1..T. The
    arrays stay float64: the sampler folds its coefficients from them."""

    beta: np.ndarray  # [T]
    alpha: np.ndarray  # [T+1], alpha[0] = 1
    alphabar: np.ndarray  # [T+1]
    T: int

    def snr(self, t: np.ndarray) -> np.ndarray:
        atbar = self.alphabar[t]
        return atbar / (1.0 - atbar)


def diffstg_schedule(T: int, schedule: str = "quad") -> DiffSTGSchedule:
    if schedule == "linear":
        beta = np.linspace(1e-4, 2e-2, T)
    elif schedule == "quad":
        # the reference's quad endpoint is bT**5 (diffusion_schedulers.py:55),
        # which it trains with: kept
        beta = np.linspace(1e-4 ** 0.5, (2e-2) ** 5, T) ** 2
    elif schedule == "cosine":
        offset = 0.008

        def cos_noise(t):
            return np.cos(math.pi * 0.5 * (t / T + offset) / (1 + offset)) ** 2

        alphabar = cos_noise(np.arange(0, T + 1, 1)) / cos_noise(0)
        beta = np.clip(1 - (alphabar[1:] / alphabar[:-1]), None, 0.999)
    else:
        raise ValueError(f"unknown DiffSTG schedule {schedule!r}")
    alpha = np.concatenate([[1.0], 1.0 - beta])
    alphabar = np.cumprod(alpha)
    return DiffSTGSchedule(
        beta=np.asarray(beta, np.float64),
        alpha=np.asarray(alpha, np.float64),
        alphabar=np.asarray(alphabar, np.float64),
        T=T,
    )


def inference_time_pairs(inference_schedule: str, T: int, inference_T: int):
    """DiffSTG's reduced-step (t1, t2) pairs (diffusion_schedulers.py:99-125)."""
    pairs = []
    for i in range(inference_T):
        if inference_schedule == "linear":
            t1 = T - int((float(i) / inference_T) * T)
            t2 = T - int((float(i + 1) / inference_T) * T)
        elif inference_schedule == "cosine":
            t1 = T - int(np.sin((float(i) / inference_T) * np.pi / 2) * T)
            t2 = T - int(np.sin((float(i + 1) / inference_T) * np.pi / 2) * T)
        else:
            raise ValueError(f"unknown inference schedule {inference_schedule!r}")
        t1 = int(np.clip(t1, 1, T))
        t2 = int(np.clip(t2, 0, T - 1))
        pairs.append((t1, t2))
    return pairs


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int):
    """DiffusionTS's DDIM (time, time_next) pairs (DiffusionTS.py:280-284);
    the last pair's time_next is -1."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return list(zip(times[:-1], times[1:]))
