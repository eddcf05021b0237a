"""Plain float32 reference of NsDiff: the weights it holds, the sampled
ensemble's mean predictive variance (MPV) over rolling windows, and the
NsDiff_model training loss.

Sampling: f(x) (the Non-stationary Transformer) and g(x) (the variance head)
run once per series; the S-member ensemble runs the heteroscedastic reverse
chain, whose every step solves the quadratic for sigma_Y0 and draws from the
posterior with the denoiser's sigma_theta; the last step returns the y_0
reparameterisation. MPV is the variance over the members of the
inverse-scaled samples, averaged over the window's series, horizon and
features; the window's mean is the average of the same samples.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import blocks
from .schedules import nsdiff_tables

EPS = 1e-7  # the reference's epsilon on gx, y_sigma and sigma_theta


def param_spec(cfg: dict):
    T = cfg["diffusion_steps"]
    F_ = cfg["dataset_nf"]
    return (blocks.ns_transformer_spec("cond_pred_model", cfg)
            + blocks.sigma_head_spec("cond_pred_model_g", cfg)
            + blocks.denoiser_spec(3 * F_, T, F_, sigma_head_out=True))


def horizon(cfg: dict) -> int:
    """Length of the chain's rows along time: pred_len."""
    return cfg["pred_len"]


def draws_per_chunk(cfg: dict) -> int:
    return cfg["diffusion_steps"]


def backbones(P, x, cfg):
    """(y0_hat, gx) [B, pred_len, F] of scaled windows x [B, W, F]."""
    y0 = blocks.ns_transformer(P, "cond_pred_model", x, cfg)[:, -cfg["pred_len"]:]
    gx = blocks.sigma_head(P, "cond_pred_model_g", x, cfg) + EPS
    return y0, gx


def _step_scalars(tab, t):
    a = float(tab.alphas[t])
    return dict(a=a, bt=float(tab.betas_tilde[t]), bb=float(tab.betas_bar[t]),
                bt1=float(tab.betas_tilde_prev[t]), bb1=float(tab.betas_bar_prev[t]),
                abar=float(tab.alphas_cumprod[t]), abar_prev=float(tab.alphas_cumprod_prev[t]))


def _sigma_y0(c, gx, sigma_theta):
    a, bt1, bb1 = c["a"], c["bt1"], c["bb1"]
    lam0 = a * (1 - a) * bt1
    lam1 = ((1 - a) ** 2 * bt1 + a * (1 - a) * (bb1 - bt1)) * gx - sigma_theta * (a * bt1 + a * (1 - a))
    lam2 = gx ** 2 * (1 - a) ** 2 * (bb1 - bt1) - sigma_theta * gx * (a * bb1 - a * bt1 + (1 - a) ** 2)
    return (-lam1 + (lam1 ** 2 - 4 * lam0 * lam2).clamp_min(0).sqrt()) / (2 * lam0)


def _y0_reparam(c, y, y0, gx, eps, sigma_theta):
    sy0 = _sigma_y0(c, gx, sigma_theta)
    noise_var = (c["bb"] - c["bt"]) * gx + c["bt"] * sy0
    sab = c["abar"] ** 0.5
    return (y - (1 - sab) * y0 - eps * noise_var.sqrt()) / sab, sy0


def chain(P, y0, gx, cfg, noise: Sequence[torch.Tensor], mm=blocks.f32_mm):
    """The reverse chain over rows y0, gx [..., F]; ``noise`` holds the T
    standard normals shaped like the rows: z_T, then one a step t = T-1 .. 1."""
    tab = nsdiff_tables(cfg["diffusion_steps"], cfg["beta_start"], cfg["beta_end"])
    T = tab.steps
    y = gx.sqrt() * noise[0] + y0
    for i, t in enumerate(range(T - 1, 0, -1)):
        c = _step_scalars(tab, t)
        eps, sig = blocks.nsdiff_denoiser(P, y, y0, gx, t, mm)
        y0r, sy0 = _y0_reparam(c, y, y0, gx, eps, sig)
        a, bb1, bt1 = c["a"], c["bb1"], c["bt1"]
        s1 = (1 - a) ** 2 * gx + a * (1 - a) * sy0
        s2 = (bb1 - bt1) * gx + bt1 * sy0
        den = a * s2 + s1
        sa, sabp = a ** 0.5, c["abar_prev"] ** 0.5
        mean = (sabp * s1 * y0r + sa * s2 * y + ((sa * (a - 1)) * s2 + (1 - sabp) * s1) * y0) / den
        y = mean + sig.sqrt() * noise[i + 1]
    eps, sig = blocks.nsdiff_denoiser(P, y, y0, gx, 0, mm)
    return _y0_reparam(_step_scalars(tab, 0), y, y0, gx, eps, sig)[0]


def samples(P, x, cfg, noise: Sequence[torch.Tensor], mm=blocks.f32_mm,
            backbone: Callable = backbones):
    """Ensemble [S, B, pred_len, F] of scaled windows x [B, W, F]; each noise
    tensor is [S, B, pred_len, F]."""
    y0, gx = backbone(P, x, cfg)
    S = noise[0].shape[0]
    rows = lambda v: v[None].expand(S, *v.shape)
    return chain(P, rows(y0), rows(gx), cfg, noise, mm)


# -- training ----------------------------------------------------------------------
def train_loss(P, cfg, batch, gen, drop_rate: float):
    """The NsDiff_model loss on batch [B, W + P, F] with dropout on, drawing
    from ``gen`` in this order: the antithetic timesteps (B // 2 + 1 integers
    in [0, T), then their mirrors T - 1 - t, cut to B), every dropout mask of
    f(x) in the order its forward applies them (uniforms below 1 - rate
    keep, scaled by 1 / (1 - rate)), then the standard normal of the forward
    sample."""
    W, Pn = cfg["windows"], cfg["pred_len"]
    dev = batch.device
    x, y = batch[:, :W], batch[:, W:W + Pn]
    B = batch.shape[0]
    tab = nsdiff_tables(cfg["diffusion_steps"], cfg["beta_start"], cfg["beta_end"])
    T = tab.steps
    half = torch.randint(0, T, (B // 2 + 1,), generator=gen, device=dev)
    t = torch.cat([half, T - 1 - half])[:B]
    keep = 1.0 - drop_rate

    def drop(h):
        mask = torch.rand(h.shape, generator=gen, device=dev) < keep
        return torch.where(mask, h / keep, 0.0)

    y0 = blocks.ns_transformer(P, "cond_pred_model", x, cfg, drop if drop_rate > 0 else blocks.identity)
    y0 = y0[:, -Pn:]
    gx = blocks.sigma_head(P, "cond_pred_model_g", x, cfg) + EPS
    y_sigma = blocks.trailing_variance(torch.cat([x, y], dim=1), cfg["rolling_length"])[:, -Pn:] + EPS
    e = torch.randn(y.shape, generator=gen, device=dev)

    col = lambda arr: torch.as_tensor(arr, dtype=torch.float32, device=dev)[t].reshape(B, 1, 1)
    a, bt, bb = col(tab.alphas), col(tab.betas_tilde), col(tab.betas_bar)
    bt1, bb1 = col(tab.betas_tilde_prev), col(tab.betas_bar_prev)
    sab = col(tab.alphas_cumprod).sqrt()
    y_t = sab * y + (1 - sab) * y0 + e * ((bb - bt) * gx + bt * y_sigma).sqrt()
    eps, sigma_theta = blocks.nsdiff_denoiser(P, y_t, y0, gx, t.reshape(B, 1))
    s1 = (1 - a) ** 2 * gx + a * (1 - a) * y_sigma
    s2 = (bb1 - bt1) * gx + bt1 * y_sigma
    ratio = (s1 * s2 / (a * s2 + s1)) / (sigma_theta + EPS)
    kl = ((e - eps) ** 2).mean() + ratio.mean() - ratio.log().mean()
    return kl + ((y0 - y) ** 2).mean() + ((gx.sqrt() - y_sigma.sqrt()) ** 2).mean()
