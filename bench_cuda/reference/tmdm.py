"""Plain float32 reference of TMDM: the weights it holds and the sampled
ensemble's mean predictive variance over rolling windows.

The conditional predictor is the Non-stationary Transformer with a VAE
latent between encoder and decoder, at its mean when sampling: the decoder
reads z_out(z_mean(enc)), each a two-layer ReLU MLP of width d_model, and
its output over label_len + pred_len steps is y_0_hat. The ensemble runs the
CARD reverse chain (Han et al., "CARD: Classification and Regression
Diffusion Models"): y_T = z + y_0_hat, then for t = T-1 .. 1

    y0_rep = (y - (1 - sqrt(abar_t)) y0_hat - eps sqrt(1 - abar_t)) / sqrt(abar_t)
    y      = g0 y0_rep + g1 y + g2 y0_hat + sqrt(beta_tilde_t) z

with g0 = beta_t sqrt(abar_{t-1}) / (1 - abar_t), g1 = (1 - abar_{t-1})
sqrt(alpha_t) / (1 - abar_t), g2 = 1 + (sqrt(abar_t) - 1)(sqrt(alpha_t) +
sqrt(abar_{t-1})) / (1 - abar_t) and beta_tilde_t = (1 - abar_{t-1}) /
(1 - abar_t) beta_t; the last step returns y0_rep. The last pred_len steps
are the forecast.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import blocks
from .schedules import card_tables


def param_spec(cfg: dict):
    T, F_, d = cfg["diffusion_steps"], cfg["dataset_nf"], cfg["d_model"]
    spec = blocks.ns_transformer_spec("cond_pred_model", cfg)
    for name in ("z_mean", "z_logvar", "z_out"):
        for i in (0, 1):
            spec += blocks._dense_spec(f"cond_pred_model.{name}_{i}", d, d)
    spec += blocks._embed_spec("enc_embedding", F_, cfg.get("CART_input_x_embed_dim", d))
    return spec + blocks.denoiser_spec(2 * F_, T + 1, F_, sigma_head_out=False)


def horizon(cfg: dict) -> int:
    """Length of the chain's rows along time: label_len + pred_len."""
    return cfg["label_len"] + cfg["pred_len"]


def draws_per_chunk(cfg: dict) -> int:
    return cfg["diffusion_steps"]


def _mlp(P, name, h):
    return blocks.dense(P, name + "_1", torch.relu(blocks.dense(P, name + "_0", h)))


def backbones(P, x, cfg):
    """y_0_hat [B, label_len + pred_len, F] of scaled windows x [B, W, F]."""
    latent = lambda enc: _mlp(P, "cond_pred_model.z_out", _mlp(P, "cond_pred_model.z_mean", enc))
    return blocks.ns_transformer(P, "cond_pred_model", x, cfg, latent=latent)


def chain(P, y0, cfg, noise: Sequence[torch.Tensor], mm=blocks.f32_mm):
    tab = card_tables(cfg["diffusion_steps"], cfg["beta_start"], cfg["beta_end"])
    T = tab.steps

    def reparam(y, t):
        eps = blocks.tmdm_denoiser(P, y, y0, t, mm)
        abar = float(tab.alphas_cumprod[t])
        return (y - (1 - abar ** 0.5) * y0 - eps * (1 - abar) ** 0.5) / abar ** 0.5

    y = noise[0] + y0
    for i, t in enumerate(range(T - 1, 0, -1)):
        a, beta = float(tab.alphas[t]), float(tab.betas[t])
        abar, abar_prev = float(tab.alphas_cumprod[t]), float(tab.alphas_cumprod_prev[t])
        g0 = beta * abar_prev ** 0.5 / (1 - abar)
        g1 = (1 - abar_prev) * a ** 0.5 / (1 - abar)
        g2 = 1 + (abar ** 0.5 - 1) * (a ** 0.5 + abar_prev ** 0.5) / (1 - abar)
        beta_tilde = (1 - abar_prev) / (1 - abar) * beta
        y = g0 * reparam(y, t) + g1 * y + g2 * y0 + beta_tilde ** 0.5 * noise[i + 1]
    return reparam(y, 0)


def samples(P, x, cfg, noise: Sequence[torch.Tensor], mm=blocks.f32_mm,
            backbone: Callable = backbones):
    """Ensemble [S, B, pred_len, F] of scaled windows x [B, W, F]; each noise
    tensor is [S, B, label_len + pred_len, F]."""
    y0 = backbone(P, x, cfg)
    S = noise[0].shape[0]
    out = chain(P, y0[None].expand(S, *y0.shape), cfg, noise, mm)
    return out[:, :, -cfg["pred_len"]:]
