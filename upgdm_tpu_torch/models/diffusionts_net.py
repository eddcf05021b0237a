"""DiffusionTS denoising transformer: trend/season decomposed output.

Counterpart of ``upgdm_tpu/models/diffusionts_net.py`` (reference
diffusionts_transformer.py: Transformer :381-438, TrendBlock :12-34,
FourierLayer :52-97, Encoder/Decoder blocks :204-378; diffusionts_model_utils.py:
Conv_MLP :151-161, AdaLayerNorm :187-202, GELU2 :180-184). Tokens are
[B, T, C] with T = windows + pred_len. Submodules carry flax's names, the
automatic ones included (``FullAttention_0``, ``Dense_0``, ``Conv_0``), so
``utils/weights.py`` maps checkpoints with transposes only.

Layouts the JAX module hides in its convolutions:
  - ``TimeMixConv`` is a conv over the embedding axis with time as channels:
    torch's Conv1d on [B, C=T, L=E] as it stands;
  - ``TrendBlock``'s ``feat_conv`` convolves over a width of 3 (the
    polynomial axis) with the embedding as channels;
  - ``TimeMixDense`` (``proj``, ``combine_m``) is a Dense over the time axis
    whose flax kernel is [T_out, T_in], held here as [T_in, T_out];
  - ``combine_s`` is a circular conv over time, k 5 / pad 2 unless the series
    is short and narrow (``_combine_kernel``).

``FourierLayer`` has the JAX package's two routes: ``torch.fft.rfft`` and
the sum of 2k cosines, or (``use_dft_matmul``) the DFT as two matmuls and
the extrapolation as two more over the scattered top-k spectrum. The
default takes the matmuls off the CPU, as JAX takes them off its CPU
backend, so the card runs the route JAX runs on its accelerator (banks in
the token's type in bf16 sampling).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import CrossAttention, FullAttention
from .dropout import Dropout
from .embedding import LearnablePositionalEncoding, sinusoidal_time_embedding
from .layers import Conv1d, LayerNorm, Linear, gelu, gelu2, promote

__all__ = ["DTSTransformer", "FourierLayer", "TrendBlock", "TimeMixDense", "AdaLayerNorm"]

_ACT = {"GELU": gelu, "GELU2": gelu2}
LN_EPS = 1e-6  # flax's LayerNorm epsilon


class AdaLayerNorm(nn.Module):
    """LayerNorm without scale and bias, modulated by the diffusion-timestep
    embedding; the embedding is taken in the token's type, so a bf16
    sampling pass stays bf16."""

    def __init__(self, n_embd: int):
        super().__init__()
        self.n_embd = n_embd
        self.Dense_0 = Linear(n_embd, 2 * n_embd)

    def forward(self, x, timestep):
        emb = sinusoidal_time_embedding(timestep, self.n_embd).to(x.dtype)
        scale, shift = self.Dense_0(F.silu(emb))[:, None, :].chunk(2, dim=2)
        return F.layer_norm(x, (self.n_embd,), eps=LN_EPS) * (1 + scale) + shift


class ConvMLP(nn.Module):
    """Conv1d (k 3, zero padding 1) over time, then dropout: [B, T, C_in] ->
    [B, T, C_out]."""

    def __init__(self, in_dim: int, out_dim: int, resid_pdrop: float = 0.0):
        super().__init__()
        self.Conv_0 = Conv1d(in_dim, out_dim, 3, padding=1)
        self.dropout = Dropout(resid_pdrop)

    def forward(self, x, gen=None):
        return self.dropout(self.Conv_0(x.transpose(1, 2)).transpose(1, 2), gen)


class TimeMixDense(nn.Module):
    """Dense over the time axis, the reference's Conv1d(T_in -> T_out, k 1):
    [B, T_in, D] -> [B, T_out, D]."""

    def __init__(self, t_in: int, t_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(t_in, t_out))
        self.bias = nn.Parameter(torch.zeros(t_out))

    def forward(self, x):
        w, x, b = promote(self.weight, x, self.bias)
        return torch.einsum("to,btd->bod", w, x) + b[None, :, None]


class TimeMixConv(nn.Module):
    """Conv1d with the time axis of [B, T, E] as its channels, over E:
    [B, T, E] -> [B, out_channels, E]."""

    def __init__(self, t_in: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = Conv1d(t_in, out_channels, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        return self.Conv_0(x)


class TrendBlock(nn.Module):
    """Polynomial trend regressor: [B, T, E] -> trend values [B, out_dim,
    out_feat]. The polynomial basis is the JAX package's float32 constant
    (a bf16 pass promotes to float32 there, as in JAX)."""

    def __init__(self, t_in: int, n_embd: int, out_dim: int, out_feat: int,
                 activation: str = "GELU", trend_poly: int = 3):
        super().__init__()
        self.act = _ACT[activation]
        self.trend_conv = TimeMixConv(t_in, trend_poly, kernel_size=3)
        self.feat_conv = Conv1d(n_embd, out_feat, 3, padding=1)
        lin_space = np.arange(1, out_dim + 1, dtype=np.float32) / (out_dim + 1)
        self._poly = np.stack([lin_space ** (p + 1) for p in range(trend_poly)], axis=0)
        self._poly_on = {}  # device -> the basis there (a float32 constant, never cast)

    def forward(self, x):
        h = self.act(self.trend_conv(x))  # [B, 3, E]
        h = self.feat_conv(h.transpose(1, 2)).transpose(1, 2)  # [B, 3, out_feat]
        poly = self._poly_on.get(h.device)
        if poly is None:
            poly = self._poly_on[h.device] = torch.from_numpy(self._poly).to(h.device)
        h, poly = promote(h, poly)
        return torch.einsum("bpf,po->bof", h, poly)


class FourierLayer(nn.Module):
    """Top-k frequency extrapolation: [B, T, D] -> [B, T, D]. No weights.
    ``use_dft_matmul=None`` takes the matmul route off the CPU."""

    def __init__(self, low_freq: int = 1, factor: int = 1,
                 use_dft_matmul: Optional[bool] = None):
        super().__init__()
        self.low_freq, self.factor, self.use_dft_matmul = low_freq, factor, use_dft_matmul
        self._banks = {}  # (T, device, dtype) -> constant tables of the matmul route

    def _route_matmul(self, x) -> bool:
        if self.use_dft_matmul is None:
            return x.device.type != "cpu"
        return self.use_dft_matmul

    def _freqs(self, T):
        f = np.fft.rfftfreq(T)
        return f[self.low_freq : -1] if T % 2 == 0 else f[self.low_freq :]

    def _tables(self, T, x):
        """(DFT cos bank, sin bank [T, T//2+1], extrapolation cos, sin
        [F, T]) in the token's type on its device, built once."""
        key = (T, x.device, x.dtype)
        if key not in self._banks:
            tf = 2.0 * np.pi * np.outer(np.arange(T), np.arange(T // 2 + 1)) / T
            t = torch.arange(T, dtype=torch.float32, device=x.device)
            f = torch.as_tensor(self._freqs(T), dtype=torch.float32, device=x.device)
            ang = 2 * math.pi * f[:, None] * t[None, :]  # float32 angles, values rounded
            self._banks[key] = (torch.as_tensor(np.cos(tf), dtype=x.dtype, device=x.device),
                                torch.as_tensor(np.sin(tf), dtype=x.dtype, device=x.device),
                                torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype))
        return self._banks[key]

    def forward(self, x):
        B, T, D = x.shape
        matmul = self._route_matmul(x)
        if matmul:
            cos_bank, sin_bank, wave_cos, wave_sin = self._tables(T, x)
            re = torch.einsum("btd,tf->bfd", x, cos_bank)
            im = -torch.einsum("btd,tf->bfd", x, sin_bank)
            x_freq = torch.complex(re.float(), im.float())
        else:
            x_freq = torch.fft.rfft(x.float(), dim=1)
        x_freq = x_freq[:, self.low_freq : -1] if T % 2 == 0 else x_freq[:, self.low_freq :]
        length = x_freq.shape[1]
        top_k = max(1, min(int(self.factor * math.log(length)), length))
        xfT = x_freq.transpose(1, 2)  # [B, D, F]
        idx = torch.topk(xfT.abs(), top_k, dim=2).indices  # [B, D, k]
        sel = torch.gather(xfT, 2, idx)
        if matmul:
            # the k kept coefficients scattered back into the spectrum; the
            # +/-f conjugate pair of the reference sums to 2 (Re cos - Im sin)
            re = x.new_zeros(B, D, length).scatter_add(2, idx, sel.real.to(x.dtype))
            im = x.new_zeros(B, D, length).scatter_add(2, idx, sel.imag.to(x.dtype))
            return 2.0 * (torch.einsum("bdl,lt->btd", re, wave_cos)
                          - torch.einsum("bdl,lt->btd", im, wave_sin))
        f = torch.as_tensor(self._freqs(T), dtype=torch.float32, device=x.device)
        t = torch.arange(T, dtype=torch.float32, device=x.device)
        f_sel = f[idx]
        both = torch.cat([sel, sel.conj()], dim=2)  # conjugates at negative frequencies
        freqs = torch.cat([f_sel, -f_sel], dim=2)
        wave = both.abs()[..., None] * torch.cos(
            2 * math.pi * freqs[..., None] * t[None, None, None, :] + both.angle()[..., None])
        return wave.sum(dim=2).transpose(1, 2)


class DTSEncoderBlock(nn.Module):
    def __init__(self, n_embd, n_head, attn_pdrop=0.0, resid_pdrop=0.0, mlp_hidden_times=4,
                 activation="GELU"):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd)
        self.FullAttention_0 = FullAttention(n_embd, n_head, attn_pdrop, resid_pdrop)
        self.ln2 = LayerNorm(n_embd, eps=LN_EPS)
        self.Dense_0 = Linear(n_embd, mlp_hidden_times * n_embd)
        self.Dense_1 = Linear(mlp_hidden_times * n_embd, n_embd)
        self.act = _ACT[activation]
        self.dropout = Dropout(resid_pdrop)

    def forward(self, x, timestep, mask=None, gen=None):
        x = x + self.FullAttention_0(self.ln1(x, timestep), mask=mask, gen=gen)[0]
        h = self.Dense_1(self.act(self.Dense_0(self.ln2(x))))
        return x + self.dropout(h, gen)


class DTSDecoderBlock(nn.Module):
    def __init__(self, n_channel, n_feat, n_embd, n_head, attn_pdrop=0.0, resid_pdrop=0.0,
                 mlp_hidden_times=4, activation="GELU", condition_dim=64):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd)
        self.FullAttention_0 = FullAttention(n_embd, n_head, attn_pdrop, resid_pdrop)
        self.ln1_1 = AdaLayerNorm(n_embd)
        self.CrossAttention_0 = CrossAttention(n_embd, condition_dim, n_head, attn_pdrop,
                                               resid_pdrop)
        self.proj = TimeMixDense(n_channel, 2 * n_channel)
        self.trend = TrendBlock(n_channel, n_embd, n_channel, n_feat, activation)
        self.seasonal = FourierLayer()
        self.ln2 = LayerNorm(n_embd, eps=LN_EPS)
        self.Dense_0 = Linear(n_embd, mlp_hidden_times * n_embd)
        self.Dense_1 = Linear(mlp_hidden_times * n_embd, n_embd)
        self.linear = Linear(n_embd, n_feat)
        self.act = _ACT[activation]
        self.dropout = Dropout(resid_pdrop)

    def forward(self, x, encoder_output, timestep, mask=None, gen=None):
        x = x + self.FullAttention_0(self.ln1(x, timestep), mask=mask, gen=gen)[0]
        x = x + self.CrossAttention_0(self.ln1_1(x, timestep), encoder_output, mask=mask,
                                      gen=gen)[0]
        x1, x2 = self.proj(x).chunk(2, dim=1)  # T -> 2T over time, split
        trend, season = self.trend(x1), self.seasonal(x2)
        h = self.Dense_1(self.act(self.Dense_0(self.ln2(x))))
        x = x + self.dropout(h, gen)
        m = x.mean(dim=1, keepdim=True)
        return x - m, self.linear(m), trend, season


class DTSTransformer(nn.Module):
    """(x [B, T, n_feat], t [B]) -> (trend, season_error), each [B, T,
    n_feat]; the model's output is their sum (DiffusionTS.py:147-150).
    ``gen`` turns dropout on."""

    def __init__(self, n_feat, n_channel, n_layer_enc=3, n_layer_dec=6, n_embd=64, n_heads=4,
                 attn_pdrop=0.0, resid_pdrop=0.0, mlp_hidden_times=4, activation="GELU",
                 conv_kernel=None):
        super().__init__()
        self.n_channel, self.n_feat, self.n_embd = n_channel, n_feat, n_embd
        self.n_layer_enc, self.n_layer_dec = n_layer_enc, n_layer_dec
        self.emb = ConvMLP(n_feat, n_embd, resid_pdrop)
        self.pos_enc = LearnablePositionalEncoding(n_embd, n_channel, resid_pdrop)
        for i in range(n_layer_enc):
            setattr(self, f"enc_{i}", DTSEncoderBlock(n_embd, n_heads, attn_pdrop, resid_pdrop,
                                                      mlp_hidden_times, activation))
        self.pos_dec = LearnablePositionalEncoding(n_embd, n_channel, resid_pdrop)
        for i in range(n_layer_dec):
            setattr(self, f"dec_{i}", DTSDecoderBlock(n_channel, n_feat, n_embd, n_heads,
                                                      attn_pdrop, resid_pdrop, mlp_hidden_times,
                                                      activation, n_embd))
        self.inverse = ConvMLP(n_embd, n_feat, resid_pdrop)
        self.k, self.pad = self._combine_kernel(conv_kernel)
        self.combine_s = Conv1d(n_embd, n_feat, self.k, bias=False)
        self.combine_m = TimeMixDense(n_layer_dec, 1)

    def _combine_kernel(self, conv_kernel):
        """combine_s's (kernel, circular pad) (diffusionts_transformer.py:381-438)."""
        if conv_kernel is not None:
            return conv_kernel, conv_kernel // 2
        if self.n_feat < 32 and self.n_channel < 64:
            return 1, 0
        return 5, 2

    def forward(self, x, t, padding_masks=None, gen=None, return_res=False):
        emb = self.emb(x, gen)
        enc_cond = self.pos_enc(emb, gen)
        for i in range(self.n_layer_enc):
            enc_cond = getattr(self, f"enc_{i}")(enc_cond, t, mask=padding_masks, gen=gen)
        h = self.pos_dec(emb, gen)
        B = x.shape[0]
        season = x.new_zeros(B, self.n_channel, self.n_embd)
        trend = x.new_zeros(B, self.n_channel, self.n_feat)
        means = []
        for i in range(self.n_layer_dec):
            h, residual_mean, residual_trend, residual_season = getattr(self, f"dec_{i}")(
                h, enc_cond, t, mask=padding_masks, gen=gen)
            season = season + residual_season
            trend = trend + residual_trend
            means.append(residual_mean)
        mean = torch.cat(means, dim=1)  # [B, n_layer_dec, n_feat]

        res = self.inverse(h, gen)
        res_m = res.mean(dim=1, keepdim=True)
        # combine_s: Conv1d(n_embd -> n_feat, k, circular) over time
        season_t = season.transpose(1, 2)
        if self.pad > 0:
            season_t = F.pad(season_t, (self.pad, self.pad), mode="circular")
        season_mapped = self.combine_s(season_t).transpose(1, 2)
        season_error = season_mapped + res - res_m
        # combine_m: Conv1d(n_layer_dec -> 1, k 1) over the layer axis
        trend_total = self.combine_m(mean) + res_m + trend
        if return_res:
            return trend_total, season_mapped, res - res_m
        return trend_total, season_error
