"""The benchmark's yardstick, frozen here so that a change to the program
cannot move it: the published peaks of one NVIDIA H100 SXM, the least time a
step kernel could take (``bound_ms`` with ``k1_work``/``k3_work``, a copy of
the port's ``ops/kernels/roofline.py`` as of its first benchmark), and the
matrix FLOPs a sweep chunk and a train step need, counted from shapes.

A kernel's bound is the largest of three terms: bytes over the memory rate
(each input read once, each output written once), matrix operations over
the peak rate of the matmul type, and special-function results (exp, log,
rsqrt) over 16 a clock on each of the 132 SMs.
"""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, 700 W
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16
SM_COUNT = 132
HID = 128


def bound_ms(flops: float, nbytes: float, sfu: float, matmul_dtype: str,
             sm_clock_hz: float) -> Tuple[float, str]:
    """(milliseconds, which term binds)."""
    terms = {
        "operations": flops / PEAK_FLOPS[matmul_dtype],
        "bytes": nbytes / PEAK_BYTES,
        "special_functions": sfu / (SFU_PER_CLOCK_PER_SM * SM_COUNT * sm_clock_hz),
    }
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def _softplus(n: float) -> float:
    return 2.0 * n  # one exp and one log each


def k1_work(M: int, F: int = 1) -> Tuple[float, float, float]:
    """(flops, bytes, special-function results) of one K1 call on M rows:
    x [M, 3F] in, eps and sigma [M, F] out; per row 4 x 128 + F softplus and
    three rsqrt."""
    flops = 2.0 * M * (3 * F * HID + 2 * HID * HID + 2 * HID * F)
    nbytes = 4.0 * M * (3 * F + 2 * F)
    sfu = M * (_softplus(4 * HID + F) + 3)
    return flops, nbytes, sfu


def k3_work(M: int, F: int = 1) -> Tuple[float, float, float]:
    """One K3 call on M rows: x [M, 2F] in, eps [M, F] out; 3 x 128 softplus."""
    flops = 2.0 * M * (2 * F * HID + 2 * HID * HID + HID * F)
    nbytes = 4.0 * M * (2 * F + F)
    sfu = M * _softplus(3 * HID)
    return flops, nbytes, sfu


# -- matrix FLOPs from shapes (2 per multiply-add; elementwise work not counted) --
def _attention(B, Lq, Lk, d) -> float:
    """Projections q and out over Lq, k and v over Lk, scores and weights."""
    return 2.0 * B * (2 * Lq * d * d + 2 * Lk * d * d + 2 * Lq * Lk * d)


def ns_transformer_flops(cfg: dict, B: int, vae: bool = False) -> float:
    """One forward of the Non-stationary Transformer on B series."""
    S, L, P, F = cfg["windows"], cfg["label_len"], cfg["pred_len"], cfg["dataset_nf"]
    d, dff = cfg["d_model"], cfg["d_ff"]
    hid = list(cfg["p_hidden_dims"])[: cfg["p_hidden_layers"]]
    Lq = L + P
    fl = 0.0
    for out in (1, S):  # tau and delta learners
        dims = [2 * F] + hid + [out]
        fl += 2.0 * B * F * 3 * S + sum(2.0 * B * a * b for a, b in zip(dims, dims[1:]))
    fl += 2.0 * B * (S + Lq) * 3 * F * d  # token convolutions
    fl += cfg["e_layers"] * (_attention(B, S, S, d) + 4.0 * B * S * d * dff)
    fl += cfg["d_layers"] * (_attention(B, Lq, Lq, d) + _attention(B, Lq, S, d)
                             + 4.0 * B * Lq * d * dff)
    fl += 2.0 * B * Lq * d * F
    if vae:  # z_mean and z_out at sampling, two d x d layers each
        fl += 2 * 2 * 2.0 * B * S * d * d
    return fl


def sigma_head_flops(cfg: dict, B: int, hidden: int = 512) -> float:
    F, W, P = cfg["dataset_nf"], cfg["windows"], cfg["pred_len"]
    k = cfg["rolling_length"]
    return 2.0 * B * F * ((W - k) * hidden + hidden * hidden + hidden * P)


def chunk_flops(family: str, cfg: dict, series: int, samples: int) -> float:
    """Matrix FLOPs of one sweep chunk of ``series`` series: the backbones
    once, then every step of the reverse chain over samples x series x
    horizon rows."""
    F, T = cfg["dataset_nf"], cfg["diffusion_steps"]
    if family == "nsdiff":
        rows = samples * series * cfg["pred_len"]
        return (ns_transformer_flops(cfg, series) + sigma_head_flops(cfg, series)
                + T * k1_work(rows, F)[0])
    if family == "tmdm":
        rows = samples * series * (cfg["label_len"] + cfg["pred_len"])
        emb = 2.0 * series * cfg["windows"] * 3 * F * cfg["d_model"]
        return ns_transformer_flops(cfg, series, vae=True) + emb + T * k3_work(rows, F)[0]
    raise KeyError(family)


def train_step_flops(family: str, cfg: dict, batch: int) -> float:
    """Matrix FLOPs of one NsDiff_model train step on ``batch`` windows: the
    forward (f, g and one denoiser pass over batch x pred_len rows) and the
    backward, counted as twice the forward."""
    if family != "nsdiff":
        raise KeyError(family)
    fwd = (ns_transformer_flops(cfg, batch) + sigma_head_flops(cfg, batch)
           + k1_work(batch * cfg["pred_len"], cfg["dataset_nf"])[0])
    return 3.0 * fwd
