"""NsDiff and CARD (TMDM) diffusion math: the forward (training) terms and
the reverse chains.

Counterpart of the NsDiff and TMDM/CARD sections of
``upgdm_tpu/ops/diffusion.py`` (nsdiff_utils.py:40-158,163-239,271-284 and
tmdm_diffusion_utils.py:42-119 of the reference). A reverse chain is a
Python loop over t; the denoiser is injected as ``model_fn(y, t)`` so the
same loop runs the plain module on the CPU and the fused kernel on the card.

Gaussians come from ``torch.randn(..., generator=g)``. The optional
``noise`` argument (z_T first, then one tensor per step t = T-1 .. 1) is a
test seam that lets a test hand the loop the exact normals another
implementation drew.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

EPS = 10e-8  # the reference's epsilon (NsDiff_model.py:37): 1e-7

__all__ = [
    "EPS",
    "NsDiffCoeffs",
    "nsdiff_gather",
    "nsdiff_gammas",
    "nsdiff_forward_noise",
    "nsdiff_sigma_tilde",
    "nsdiff_q_sample",
    "nsdiff_p_sample_loop",
    "card_q_sample",
    "card_p_sample_loop",
    "schedule_on",
]


def schedule_on(sched, device):
    """The schedule with every array as a float32 tensor on ``device``."""
    return dataclasses.replace(sched, **{
        f.name: torch.as_tensor(np.asarray(getattr(sched, f.name), np.float32), device=device)
        for f in dataclasses.fields(sched)
    })


class NsDiffCoeffs(NamedTuple):
    """Per-timestep schedule gathers; each broadcasts against the data."""

    alpha_t: torch.Tensor
    betas_tilde_t: torch.Tensor
    betas_bar_t: torch.Tensor
    betas_tilde_m_1_t: torch.Tensor
    betas_bar_m_1_t: torch.Tensor
    alphas_cumprod_prev_t: torch.Tensor
    one_minus_abar_sqrt_t: torch.Tensor


def _gather(arr, t, like: torch.Tensor) -> torch.Tensor:
    """arr[t] (float32) shaped to broadcast against ``like``; ``arr`` is a
    numpy array or a tensor, ``t`` a step or one step per batch row."""
    if isinstance(t, torch.Tensor):
        t = t.to(like.device, torch.long)
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr, np.float32))
    c = arr.to(like.device)[t]
    return c.reshape(c.shape + (1,) * (like.ndim - c.ndim)) if c.ndim else c


def nsdiff_gather(sched, t, like: torch.Tensor) -> NsDiffCoeffs:
    """Gather all NsDiff per-step coefficients (float32) for scalar or
    per-batch t, shaped to broadcast against ``like``.

    The schedule's arrays may be numpy or tensors already on the data's
    device (``schedule_on``), which keeps the per-step gather off the
    host-to-device link."""
    g = lambda arr: _gather(arr, t, like)
    return NsDiffCoeffs(
        alpha_t=g(sched.alphas),
        betas_tilde_t=g(sched.betas_tilde),
        betas_bar_t=g(sched.betas_bar),
        betas_tilde_m_1_t=g(sched.betas_tilde_m_1),
        betas_bar_m_1_t=g(sched.betas_bar_m_1),
        alphas_cumprod_prev_t=g(sched.alphas_cumprod_prev),
        one_minus_abar_sqrt_t=g(sched.one_minus_alphas_bar_sqrt),
    )


def _nsdiff_sigma12(c: NsDiffCoeffs, gx, y_sigma):
    """Sigma_1 / Sigma_2 of the NsDiff posterior (nsdiff_utils.py:40-56)."""
    sigma_1 = (1.0 - c.alpha_t) ** 2 * gx + c.alpha_t * (1.0 - c.alpha_t) * y_sigma
    sigma_2 = (c.betas_bar_m_1_t - c.betas_tilde_m_1_t) * gx + c.betas_tilde_m_1_t * y_sigma
    return sigma_1, sigma_2


def nsdiff_forward_noise(c: NsDiffCoeffs, gx, y_sigma):
    """Heteroscedastic forward-noise variance (nsdiff_utils.py:58-64)."""
    return (c.betas_bar_t - c.betas_tilde_t) * gx + c.betas_tilde_t * y_sigma


def nsdiff_sigma_tilde(c: NsDiffCoeffs, gx, y_sigma):
    """Posterior variance target of the KL loss (nsdiff_utils.py:75-78)."""
    s1, s2 = _nsdiff_sigma12(c, gx, y_sigma)
    return (s1 * s2) / (c.alpha_t * s2 + s1)


def nsdiff_q_sample(y, y_0_hat, sched, t, noise):
    """Forward sample with the y0_hat-shifted mean (nsdiff_utils.py:96-107).

    As in the reference, ``noise`` is added as given: it already carries
    sqrt(forward_noise)."""
    sqrt_abar = _gather(sched.alphas_bar_sqrt, t, y)
    return sqrt_abar * y + (1.0 - sqrt_abar) * y_0_hat + noise


def nsdiff_gammas(c: NsDiffCoeffs, gx, y_sigma):
    """Posterior mean coefficients gamma_0/1/2 (nsdiff_utils.py:80-92)."""
    s1, s2 = _nsdiff_sigma12(c, gx, y_sigma)
    sqrt_a = torch.sqrt(c.alpha_t)
    sqrt_abar_prev = torch.sqrt(c.alphas_cumprod_prev_t)
    denom = c.alpha_t * s2 + s1
    gamma_0 = sqrt_abar_prev * s1 / denom
    gamma_1 = sqrt_a * s2 / denom
    gamma_2 = ((sqrt_a * (c.alpha_t - 1.0)) * s2 + (1.0 - sqrt_abar_prev) * s1) / denom
    return gamma_0, gamma_1, gamma_2


def _nsdiff_sigma_y0_hat(c: NsDiffCoeffs, gx, sigma_theta):
    """Per-step quadratic solve for sigma_{Y0} (nsdiff_utils.py:143-146)."""
    a = c.alpha_t
    bt_m1 = c.betas_tilde_m_1_t
    bb_m1 = c.betas_bar_m_1_t
    lam0 = a * (1.0 - a) * bt_m1
    lam1 = ((1.0 - a) ** 2 * bt_m1 + a * (1.0 - a) * (bb_m1 - bt_m1)) * gx - sigma_theta * (
        a * bt_m1 + a * (1.0 - a)
    )
    lam2 = gx ** 2 * (1.0 - a) ** 2 * (bb_m1 - bt_m1) - sigma_theta * gx * (
        a * bb_m1 - a * bt_m1 + (1.0 - a) ** 2
    )
    disc = torch.clamp(lam1 ** 2 - 4.0 * lam0 * lam2, min=0.0)
    return (-lam1 + torch.sqrt(disc)) / (2.0 * lam0)


def _noise_var(c, gx, sigma_theta, use_gx_directly):
    if use_gx_directly:
        return gx, c.betas_bar_t * gx
    sigma_y0 = _nsdiff_sigma_y0_hat(c, gx, sigma_theta)
    return sigma_y0, (c.betas_bar_t - c.betas_tilde_t) * gx + c.betas_tilde_t * sigma_y0


def nsdiff_p_sample_loop(
    model_fn: Callable[[torch.Tensor, int], tuple],
    y_0_hat: torch.Tensor,
    gx: torch.Tensor,
    sched,
    generator: Optional[torch.Generator] = None,
    use_gx_directly: bool = False,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full NsDiff reverse chain; returns the final y_0 reparameterisation.

    model_fn(y_t, t) -> (eps_theta, sigma_theta); y_0_hat doubles as
    y_T_mean. ``use_gx_directly=True`` replaces the quadratic solve with gx
    (the ``_pe`` variant). ``noise``, when given, holds T tensors shaped like
    y_0_hat: z_T, then z for t = T-1 .. 1.
    """
    n_steps = sched.num_timesteps
    if noise is not None and len(noise) != n_steps:
        raise ValueError(f"noise: expected {n_steps} tensors, got {len(noise)}")

    def draw(i):
        if noise is not None:
            return torch.as_tensor(noise[i], dtype=y_0_hat.dtype, device=y_0_hat.device)
        return torch.randn(y_0_hat.shape, generator=generator, dtype=y_0_hat.dtype,
                           device=y_0_hat.device)

    y_T_mean = y_0_hat
    y = torch.sqrt(gx) * draw(0) + y_T_mean
    for i, t in enumerate(range(n_steps - 1, 0, -1)):
        c = nsdiff_gather(sched, t, y)
        eps_theta, sigma_theta = model_fn(y, t)
        sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
        sigma_y0, noise_var = _noise_var(c, gx, sigma_theta, use_gx_directly)
        y0_reparam = (y - (1.0 - sqrt_abar) * y_T_mean
                      - eps_theta * torch.sqrt(noise_var)) / sqrt_abar
        g0, g1, g2 = nsdiff_gammas(c, gx, sigma_y0)
        y_mean = g0 * y0_reparam + g1 * y + g2 * y_T_mean
        y = y_mean + torch.sqrt(sigma_theta) * draw(i + 1)

    # final step t=0 -> y_0 (deterministic reparameterisation)
    c = nsdiff_gather(sched, 0, y)
    eps_theta, sigma_theta = model_fn(y, 0)
    sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
    _, noise_var = _noise_var(c, gx, sigma_theta, use_gx_directly)
    return (y - (1.0 - sqrt_abar) * y_T_mean - eps_theta * torch.sqrt(noise_var)) / sqrt_abar


# ---------------------------------------------------------------------------
# TMDM / CARD — conditional diffusion with the y0_hat prior
# ---------------------------------------------------------------------------

def _host_f32(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, np.float32)


def card_q_sample(y, y_0_hat, sched, t, noise):
    """q(y_t | y_0, x) with the mean shifted toward y0_hat
    (tmdm_diffusion_utils.py:42-53); t is a scalar or one step per batch row."""
    t = torch.as_tensor(t, dtype=torch.long, device=y.device)

    def g(arr):
        c = torch.as_tensor(_host_f32(arr), device=y.device)[t]
        return c.reshape(c.shape + (1,) * (y.ndim - c.ndim))

    sqrt_abar = g(sched.alphas_bar_sqrt)
    return sqrt_abar * y + (1.0 - sqrt_abar) * y_0_hat + g(sched.one_minus_alphas_bar_sqrt) * noise


def card_p_sample_loop(
    model_fn: Callable[[torch.Tensor, int], torch.Tensor],
    y_0_hat: torch.Tensor,
    sched,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full CARD reverse chain (tmdm_diffusion_utils.py:57-119); returns the
    final y_0 reparameterisation.

    model_fn(y_t, t) -> eps_theta; y_T = z + y_0_hat (unit-variance prior).
    ``noise``, when given, holds T tensors shaped like y_0_hat: z_T, then z
    for t = T-1 .. 1.

    The per-step coefficients are float32 arithmetic on the schedule's
    float32 arrays, operation for operation what the JAX package computes on
    its device (float64 coefficients would drift from it by more than 1e-5
    over 100 steps); they are taken on the host for all steps at once, so
    no step waits on a scalar from the device.
    """
    n_steps = int(np.shape(sched.alphas)[0])
    if noise is not None and len(noise) != n_steps:
        raise ValueError(f"noise: expected {n_steps} tensors, got {len(noise)}")

    def draw(i):
        if noise is not None:
            return torch.as_tensor(noise[i], dtype=y_0_hat.dtype, device=y_0_hat.device)
        return torch.randn(y_0_hat.shape, generator=generator, dtype=y_0_hat.dtype,
                           device=y_0_hat.device)

    one = np.float32(1.0)
    alpha = _host_f32(sched.alphas)
    s1m = _host_f32(sched.one_minus_alphas_bar_sqrt)
    s1m_prev = np.roll(s1m, 1)  # entry t holds s1m[t-1]; entry 0 is never read
    sqrt_alpha = np.sqrt(alpha)
    sqrt_abar = np.sqrt(one - s1m ** 2)
    sqrt_abar_prev = np.sqrt(one - s1m_prev ** 2)
    gamma_0 = (one - alpha) * sqrt_abar_prev / (s1m ** 2)
    gamma_1 = (s1m_prev ** 2) * sqrt_alpha / (s1m ** 2)
    gamma_2 = one + (sqrt_abar - one) * (sqrt_alpha + sqrt_abar_prev) / (s1m ** 2)
    sqrt_beta_hat = np.sqrt((s1m_prev ** 2) / (s1m ** 2) * (one - alpha))
    shift = one - sqrt_abar

    def reparam(y, eps_theta, t):
        return (y - float(shift[t]) * y_T_mean - eps_theta * float(s1m[t])) / float(sqrt_abar[t])

    y_T_mean = y_0_hat
    y = draw(0) + y_T_mean
    for i, t in enumerate(range(n_steps - 1, 0, -1)):
        y0_reparam = reparam(y, model_fn(y, t), t)
        y_mean = (float(gamma_0[t]) * y0_reparam + float(gamma_1[t]) * y
                  + float(gamma_2[t]) * y_T_mean)
        y = y_mean + float(sqrt_beta_hat[t]) * draw(i + 1)
    # final step t=0 -> y_0 (deterministic reparameterisation)
    return reparam(y, model_fn(y, 0), 0)
