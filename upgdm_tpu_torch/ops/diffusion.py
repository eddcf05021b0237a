"""NsDiff, CARD (TMDM), DiffusionTS and DiffSTG diffusion math: the forward
(training) terms, the reverse chains and DiffusionTS's x0-prediction helpers.

Counterpart of ``upgdm_tpu/ops/diffusion.py``
(nsdiff_utils.py:40-158,163-239,271-284, tmdm_diffusion_utils.py:42-119,
DiffusionTS.py:96-124 and graph_diffusion_model.py:46-73 of the
reference). A reverse chain is a
Python loop over t; the denoiser is injected as ``model_fn(y, t)`` so the
same loop runs the plain module on the CPU and the fused kernel on the card.

Gaussians come from ``torch.randn(..., generator=g)`` through
``parallel/draws.py``, so a row shard draws the global batch's. The optional
``noise`` argument (z_T first, then one tensor per step t = T-1 .. 1) is a
test seam that lets a test hand the loop the exact normals another
implementation drew.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel import draws
from ..utils.profiling import annotate
from .kernels.nsdiff_chain_update import chain_table, nsdiff_chain_update

EPS = 10e-8  # the reference's epsilon (NsDiff_model.py:37): 1e-7

__all__ = [
    "EPS",
    "NsDiffCoeffs",
    "nsdiff_gather",
    "nsdiff_forward_noise",
    "nsdiff_sigma_tilde",
    "nsdiff_q_sample",
    "nsdiff_p_sample_loop",
    "card_q_sample",
    "card_p_sample_loop",
    "dts_q_sample",
    "dts_predict_noise_from_start",
    "dts_q_posterior",
    "diffstg_q_sample",
    "diffstg_posterior_step",
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


def _chain_draw(like: torch.Tensor, generator, noise, members: int):
    """``draw(i)`` of a reverse chain over rows ``like``: ``noise[i]`` when
    given, else normals shaped like the rows. The rows are ``members``
    sample-major copies of the batch, so the batch is axis 1 of
    ``(members, rows // members, ...)``."""
    shape = (members, like.shape[0] // members) + tuple(like.shape[1:])

    def draw(i):
        if noise is not None:
            return torch.as_tensor(noise[i], dtype=like.dtype, device=like.device).contiguous()
        return draws.randn(shape, generator, dtype=like.dtype, device=like.device,
                           batch_axis=1).reshape(like.shape)

    return draw


def nsdiff_p_sample_loop(
    model_fn: Callable[[torch.Tensor, int], tuple],
    y_0_hat: torch.Tensor,
    gx: torch.Tensor,
    sched,
    generator: Optional[torch.Generator] = None,
    use_gx_directly: bool = False,
    noise: Optional[Sequence[torch.Tensor]] = None,
    members: int = 1,
) -> torch.Tensor:
    """Full NsDiff reverse chain; returns the final y_0 reparameterisation.

    model_fn(y_t, t) -> (eps_theta, sigma_theta); y_0_hat doubles as
    y_T_mean. ``use_gx_directly=True`` replaces the quadratic solve with gx
    (the ``_pe`` variant). ``noise``, when given, holds T tensors shaped like
    y_0_hat: z_T, then z for t = T-1 .. 1. The rows are ``members``
    sample-major copies of the batch (``_chain_draw``).

    Each step's posterior update is one ``nsdiff_chain_update`` (a kernel
    launch on the card, its plain twin on the CPU) on the step's row of
    ``chain_table``: float32 host arithmetic on the schedule, taken once for
    the chain, so no step gathers a coefficient on the device. A schedule of
    tensors (``schedule_on``) is read back once for that. The kernel reads
    flat rows, so strided operands (NsDiff_spatial's) are made contiguous.
    """
    n_steps = sched.num_timesteps
    if noise is not None and len(noise) != n_steps:
        raise ValueError(f"noise: expected {n_steps} tensors, got {len(noise)}")
    draw = _chain_draw(y_0_hat, generator, noise, members)
    table = chain_table(sched, y_0_hat.device)

    update = annotate("upgdm.chain.update")
    y_T_mean, gx = y_0_hat.contiguous(), gx.contiguous()
    y = torch.sqrt(gx) * draw(0) + y_T_mean
    for i, t in enumerate(range(n_steps - 1, 0, -1)):
        eps_theta, sigma_theta = model_fn(y, t)
        with update:
            y = nsdiff_chain_update(y, y_T_mean, gx, eps_theta.contiguous(),
                                    sigma_theta.contiguous(), draw(i + 1), table[t],
                                    use_gx_directly)

    # final step t=0 -> y_0 (deterministic reparameterisation)
    eps_theta, sigma_theta = model_fn(y, 0)
    return nsdiff_chain_update(y, y_T_mean, gx, eps_theta.contiguous(),
                               sigma_theta.contiguous(), None, table[0], use_gx_directly)


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
    members: int = 1,
) -> torch.Tensor:
    """Full CARD reverse chain (tmdm_diffusion_utils.py:57-119); returns the
    final y_0 reparameterisation.

    model_fn(y_t, t) -> eps_theta; y_T = z + y_0_hat (unit-variance prior).
    ``noise``, when given, holds T tensors shaped like y_0_hat: z_T, then z
    for t = T-1 .. 1. The rows are ``members`` sample-major copies of the
    batch (``_chain_draw``).

    The per-step coefficients are float32 arithmetic on the schedule's
    float32 arrays, operation for operation what the JAX package computes on
    its device (float64 coefficients would drift from it by more than 1e-5
    over 100 steps); they are taken on the host for all steps at once, so
    no step waits on a scalar from the device.
    """
    n_steps = int(np.shape(sched.alphas)[0])
    if noise is not None and len(noise) != n_steps:
        raise ValueError(f"noise: expected {n_steps} tensors, got {len(noise)}")
    draw = _chain_draw(y_0_hat, generator, noise, members)

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

    update = annotate("upgdm.chain.update")
    y_T_mean = y_0_hat
    y = draw(0) + y_T_mean
    for i, t in enumerate(range(n_steps - 1, 0, -1)):
        eps_theta = model_fn(y, t)
        with update:
            y0_reparam = reparam(y, eps_theta, t)
            y_mean = (float(gamma_0[t]) * y0_reparam + float(gamma_1[t]) * y
                      + float(gamma_2[t]) * y_T_mean)
            y = y_mean + float(sqrt_beta_hat[t]) * draw(i + 1)
    # final step t=0 -> y_0 (deterministic reparameterisation)
    return reparam(y, model_fn(y, 0), 0)


# ---------------------------------------------------------------------------
# DiffusionTS — x0-prediction helpers; t is a step or one step per batch row
# ---------------------------------------------------------------------------

def dts_q_sample(x_start, sched, t, noise):
    return (_gather(sched.sqrt_alphas_cumprod, t, x_start) * x_start
            + _gather(sched.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)


def dts_predict_noise_from_start(x_t, sched, t, x0):
    return ((_gather(sched.sqrt_recip_alphas_cumprod, t, x_t) * x_t - x0)
            / _gather(sched.sqrt_recipm1_alphas_cumprod, t, x_t))


def dts_q_posterior(sched, x_start, x_t, t):
    """(posterior mean, clipped log variance) of q(x_{t-1} | x_t, x_0)."""
    mean = (_gather(sched.posterior_mean_coef1, t, x_t) * x_start
            + _gather(sched.posterior_mean_coef2, t, x_t) * x_t)
    return mean, _gather(sched.posterior_log_variance_clipped, t, x_t)


# ---------------------------------------------------------------------------
# DiffSTG — DDPM forward + DDPM/DDIM posterior on the 1-indexed schedule
# ---------------------------------------------------------------------------

def diffstg_q_sample(x0, sched, t, noise):
    """xt = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps (diffusion_schedulers.py:70-80);
    t (1-indexed into the length-(T+1) alphabar) is a scalar or one step per
    leading row."""
    t = torch.as_tensor(t, dtype=torch.long, device=x0.device)
    atbar = torch.as_tensor(sched.alphabar, dtype=x0.dtype, device=x0.device)[t]
    atbar = atbar.reshape(atbar.shape + (1,) * (x0.ndim - atbar.ndim))
    return torch.sqrt(atbar) * x0 + torch.sqrt(1.0 - atbar) * noise


def diffstg_posterior_step(sched, xt, pred_eps, t: int, target_t: int, trick: str,
                           generator: Optional[torch.Generator] = None, z=None):
    """One denoise step with static (t, target_t) ints (gaussian_posterior,
    graph_diffusion_model.py:46-73); the coefficients are Python floats, as
    the reference's host ``.item()`` scalars. ``z`` (the DDPM draw) is a
    test seam."""
    alphabar = sched.alphabar
    atbar = float(alphabar[t])
    atbar_target = float(alphabar[target_t])
    if trick == "ddpm" or t <= 1:
        at = float(sched.alpha[t])
        atbar_prev = float(alphabar[t - 1])
        beta_tilde = float(sched.beta[t - 1]) * (1.0 - atbar_prev) / (1.0 - atbar)
        if z is None:
            z = torch.randn(xt.shape, generator=generator, dtype=xt.dtype, device=xt.device)
        xt_target = (1.0 / at ** 0.5) * (xt - ((1.0 - at) / (1.0 - atbar) ** 0.5) * pred_eps)
        return xt_target + beta_tilde ** 0.5 * z
    if trick == "ddim":
        xt_target = (atbar_target / atbar) ** 0.5 * (xt - (1.0 - atbar) ** 0.5 * pred_eps)
        return xt_target + (1.0 - atbar_target) ** 0.5 * pred_eps
    raise ValueError(f"Unknown inference trick {trick!r}")
