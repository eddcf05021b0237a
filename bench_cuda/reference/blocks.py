"""Plain float32 PyTorch building blocks of the reference: the
Non-stationary Transformer (NsDiff's f(x), TMDM's conditional predictor),
NsDiff's variance head g(x) and the conditional denoisers, as functions of a
flat dict of weights named by their flax module path (``<path>.kernel``
``[in, out]``, ``<path>.bias``, LayerNorm ``<path>.scale``, convolutions
``[k, in, out]``).

Written from the architecture's description: the de-stationary attention
rescales the scores by tau and shifts them by delta before the softmax;
LayerNorm's epsilon is 1e-6; "gelu" is the tanh approximation; the series
statistics are the population mean and std (1e-5 inside the root). Dropout is
a callable ``drop(x)`` (identity when the reference runs deterministically),
so the training reference can replay a given stream of masks. The
denoisers take ``mm(a, w)`` for their matrix products, so a control can round
the operands.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
HIDDEN = 128  # the conditional denoisers' width


def identity(x):
    return x


def f32_mm(a, w):
    return a @ w


def dense(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ P[name + ".kernel"]
    b = P.get(name + ".bias")
    return y if b is None else y + b


def layer_norm(P: Params, name: str, x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-dims:], P[name + ".scale"], P[name + ".bias"], LN_EPS)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def circular_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] convolved along T with circular padding; kernel [k, C, O]."""
    k = kernel.shape[0]
    pad = k // 2
    xp = torch.cat([x[:, x.shape[1] - pad:], x, x[:, :pad]], dim=1)
    win = xp.unfold(1, k, 1)  # [B, T, C, k]
    return torch.einsum("btck,kco->bto", win, kernel)


def position_table(length: int, d: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    freq = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((length, d))
    pe[:, 0::2] = np.sin(pos * freq)
    pe[:, 1::2] = np.cos(pos * freq)[:, : pe[:, 1::2].shape[1]]
    return torch.as_tensor(pe, dtype=torch.float32, device=device)


def embed(P: Params, name: str, x: torch.Tensor, drop) -> torch.Tensor:
    tok = circular_conv(x, P[name + ".TokenEmbedding_0.CircularConv1d_0.Conv_0.kernel"])
    return drop(tok + position_table(x.shape[1], tok.shape[-1], x.device)[None])


def projector(P: Params, name: str, x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """tau/delta learner: a circular conv over the series axis with the S time
    steps as channels, joined to the series statistic, then an MLP."""
    kern = P[name + ".series_conv_kernel"]  # [k, S, 1]
    conv = circular_conv(x.transpose(1, 2), kern).transpose(1, 2)  # [B, 1, E]
    h = torch.cat([conv, stats], dim=1).reshape(x.shape[0], -1)
    i = 0
    while (name + f".Dense_{i + 1}.kernel") in P:
        h = torch.relu(dense(P, name + f".Dense_{i}", h))
        i += 1
    return dense(P, name + f".Dense_{i}", h)


def attention(P, name, q_in, kv_in, tau, delta, causal, heads, drop):
    B, L, D = q_in.shape
    S = kv_in.shape[1]
    dh = D // heads
    q = dense(P, name + ".query", q_in).reshape(B, L, heads, dh)
    k = dense(P, name + ".key", kv_in).reshape(B, S, heads, dh)
    v = dense(P, name + ".value", kv_in).reshape(B, S, heads, dh)
    scores = torch.einsum("blhe,bshe->bhls", q, k)
    if tau is not None:
        scores = scores * tau.reshape(B, 1, 1, 1)
    if delta is not None:
        scores = scores + delta.reshape(B, 1, 1, S)
    if causal:
        future = torch.ones(L, S, dtype=torch.bool, device=q_in.device).triu(1)
        scores = scores.masked_fill(future, -1e9)
    weights = drop(torch.softmax(scores / math.sqrt(dh), dim=-1))
    out = torch.einsum("bhls,bshd->blhd", weights, v).reshape(B, L, D)
    return dense(P, name + ".out", out)


def _feed_forward(P, name, x, drop):
    return drop(dense(P, name + ".Dense_1", drop(gelu(dense(P, name + ".Dense_0", x)))))


def encoder_layer(P, name, x, tau, delta, heads, drop):
    a = attention(P, name + ".AttentionLayer_0", x, x, tau, delta, False, heads, drop)
    x = layer_norm(P, name + ".LayerNorm_0", x + drop(a))
    return layer_norm(P, name + ".LayerNorm_1", x + _feed_forward(P, name, x, drop))


def decoder_layer(P, name, x, cross, tau, delta, heads, drop):
    a = attention(P, name + ".self_attn", x, x, tau, None, True, heads, drop)
    x = layer_norm(P, name + ".LayerNorm_0", x + drop(a))
    a = attention(P, name + ".cross_attn", x, cross, tau, delta, False, heads, drop)
    x = layer_norm(P, name + ".LayerNorm_1", x + drop(a))
    return layer_norm(P, name + ".LayerNorm_2", x + _feed_forward(P, name, x, drop))


def ns_transformer(P: Params, pre: str, x: torch.Tensor, cfg: dict, drop=identity,
                   latent: Optional[Callable] = None) -> torch.Tensor:
    """x [B, S, F] -> the decoder's output over label_len + pred_len steps,
    in the scale of x. ``latent(enc)`` maps the encoder's output before the
    decoder reads it (TMDM's VAE at its mean)."""
    heads = cfg["n_heads"]
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=1, keepdim=True) + 1e-5)
    xn = (x - mean) / std
    label, pred = cfg["label_len"], cfg["pred_len"]
    x_dec = torch.cat([xn[:, -label:], xn.new_zeros(x.shape[0], pred, x.shape[2])], dim=1)
    tau = torch.exp(projector(P, pre + ".tau_learner", x, std))
    delta = projector(P, pre + ".delta_learner", x, mean)
    h = embed(P, pre + ".enc_embedding", xn, drop)
    for i in range(cfg["e_layers"]):
        h = encoder_layer(P, pre + f".encoder.NSEncoderLayer_{i}", h, tau, delta, heads, drop)
    enc = layer_norm(P, pre + ".encoder.LayerNorm_0", h)
    if latent is not None:
        enc = latent(enc)
    d = embed(P, pre + ".dec_embedding", x_dec, drop)
    for i in range(cfg["d_layers"]):
        d = decoder_layer(P, pre + f".decoder.NSDecoderLayer_{i}", d, enc, tau, delta, heads,
                          drop)
    d = dense(P, pre + ".decoder.Dense_0", layer_norm(P, pre + ".decoder.LayerNorm_0", d))
    return d * std + mean


def trailing_variance(x: torch.Tensor, k: int) -> torch.Tensor:
    """Population variance of each trailing window of k steps along axis 1 of
    x [B, T, N], the first value repeated in front: [B, T, N]."""
    xp = torch.cat([x[:, :1].expand(-1, k - 1, -1), x], dim=1)
    return xp.unfold(1, k, 1).var(dim=-1, unbiased=False)


def sigma_head(P: Params, pre: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """NsDiff's g(x): [B, W, N] -> the future variance [B, pred_len, N]."""
    k = cfg["rolling_length"]
    h = (trailing_variance(x, k)[:, k:] + 1e-7).transpose(1, 2)
    h = layer_norm(P, pre + ".LayerNorm_0", torch.relu(dense(P, pre + ".Dense_0", h)), dims=2)
    h = layer_norm(P, pre + ".LayerNorm_1", torch.relu(dense(P, pre + ".Dense_1", h)), dims=2)
    return F.softplus(dense(P, pre + ".Dense_2", h)).transpose(1, 2)


def _gated(P, name, h, t, mm):
    return P[name + ".embed"][t] * (mm(h, P[name + ".Dense_0.kernel"]) + P[name + ".Dense_0.bias"])


def nsdiff_denoiser(P: Params, y, y0, gx, t, mm=f32_mm):
    """(eps, sigma) of rows [..., F]; ``t`` an int, or one step a leading
    row with the gate broadcast over the rest (``[B, 1, HIDDEN]``)."""
    h = torch.cat([y, y0, gx], dim=-1)
    for i in (1, 2, 3):
        h = F.normalize(F.softplus(_gated(P, f"model.lin{i}", h, t, mm)), dim=-1)
    eps = mm(h, P["model.lin4.kernel"]) + P["model.lin4.bias"]
    sigma = F.softplus(mm(F.softplus(h), P["model.sigma_lin.kernel"]) + P["model.sigma_lin.bias"])
    return eps, sigma


def tmdm_denoiser(P: Params, y, y0, t, mm=f32_mm):
    h = torch.cat([y, y0], dim=-1)
    for i in (1, 2, 3):
        h = F.softplus(_gated(P, f"model.lin{i}", h, t, mm))
    return mm(h, P["model.lin4.kernel"]) + P["model.lin4.bias"]


# -- the weights each family holds --------------------------------------------------
Spec = List[Tuple[str, Tuple[int, ...], str]]  # (name, shape, kind)


def _dense_spec(name, n_in, n_out, bias=True) -> Spec:
    out = [(name + ".kernel", (n_in, n_out), "kernel")]
    return out + [(name + ".bias", (n_out,), "bias")] if bias else out


def _ln_spec(name, shape) -> Spec:
    return [(name + ".scale", tuple(shape), "scale"), (name + ".bias", tuple(shape), "bias")]


def _attn_spec(name, d) -> Spec:
    return [e for p in ("query", "key", "value", "out") for e in _dense_spec(f"{name}.{p}", d, d)]


def _embed_spec(name, c_in, d) -> Spec:
    return [(name + ".TokenEmbedding_0.CircularConv1d_0.Conv_0.kernel", (3, c_in, d), "conv")]


def _projector_spec(name, S, E, hidden, out, head="kernel") -> Spec:
    spec = [(name + ".series_conv_kernel", (3, S, 1), "conv")]
    dims = [2 * E] + list(hidden)
    for i in range(len(hidden)):
        spec += _dense_spec(f"{name}.Dense_{i}", dims[i], dims[i + 1])
    return spec + [(f"{name}.Dense_{len(hidden)}.kernel", (dims[-1], out), head)]


def ns_transformer_spec(pre: str, cfg: dict) -> Spec:
    d, dff, F_, S = cfg["d_model"], cfg["d_ff"], cfg["dataset_nf"], cfg["windows"]
    hidden = list(cfg["p_hidden_dims"])[: cfg["p_hidden_layers"]]
    spec = _projector_spec(pre + ".tau_learner", S, F_, hidden, 1, head="log_scale")
    spec += _projector_spec(pre + ".delta_learner", S, F_, hidden, S)
    spec += _embed_spec(pre + ".enc_embedding", F_, d)
    for i in range(cfg["e_layers"]):
        n = pre + f".encoder.NSEncoderLayer_{i}"
        spec += _attn_spec(n + ".AttentionLayer_0", d) + _ln_spec(n + ".LayerNorm_0", [d])
        spec += _dense_spec(n + ".Dense_0", d, dff) + _dense_spec(n + ".Dense_1", dff, d)
        spec += _ln_spec(n + ".LayerNorm_1", [d])
    spec += _ln_spec(pre + ".encoder.LayerNorm_0", [d])
    spec += _embed_spec(pre + ".dec_embedding", F_, d)
    for i in range(cfg["d_layers"]):
        n = pre + f".decoder.NSDecoderLayer_{i}"
        spec += _attn_spec(n + ".self_attn", d) + _ln_spec(n + ".LayerNorm_0", [d])
        spec += _attn_spec(n + ".cross_attn", d) + _ln_spec(n + ".LayerNorm_1", [d])
        spec += _dense_spec(n + ".Dense_0", d, dff) + _dense_spec(n + ".Dense_1", dff, d)
        spec += _ln_spec(n + ".LayerNorm_2", [d])
    spec += _ln_spec(pre + ".decoder.LayerNorm_0", [d])
    return spec + _dense_spec(pre + ".decoder.Dense_0", d, F_)


def sigma_head_spec(pre: str, cfg: dict, hidden: int = 512) -> Spec:
    F_, W, P_ = cfg["dataset_nf"], cfg["windows"], cfg["pred_len"]
    spec = _dense_spec(pre + ".Dense_0", W - cfg["rolling_length"], hidden)
    spec += _ln_spec(pre + ".LayerNorm_0", [F_, hidden])
    spec += _dense_spec(pre + ".Dense_1", hidden, hidden) + _ln_spec(pre + ".LayerNorm_1", [F_, hidden])
    return spec + _dense_spec(pre + ".Dense_2", hidden, P_)


def denoiser_spec(in_dim: int, steps: int, F_: int, sigma_head_out: bool) -> Spec:
    spec: Spec = []
    dims = [in_dim, HIDDEN, HIDDEN, HIDDEN]
    for i in (1, 2, 3):
        spec += _dense_spec(f"model.lin{i}.Dense_0", dims[i - 1], dims[i])
        spec.append((f"model.lin{i}.embed", (steps, HIDDEN), "gate"))
    spec += _dense_spec("model.lin4", HIDDEN, F_)
    return spec + (_dense_spec("model.sigma_lin", HIDDEN, F_) if sigma_head_out else [])
