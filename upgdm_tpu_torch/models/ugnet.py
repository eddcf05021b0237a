"""UGnet — the graph U-Net denoiser of DiffSTG.

Counterpart of ``upgdm_tpu/models/ugnet.py`` (reference
DiffSTG/ugnet.py:36-296). Features are [B, V, T, C] with nodes an explicit
axis and a dense adjacency [V, V] or [B, V, V]; the temporal convolutions run
over T batched over (B, V). The submodules carry flax's names, automatic
ones included (``Conv_0`` of a TCN or time conv, ``<Conv>_0`` of the spatial
block), so the flat checkpoint keys are the JAX package's.

``TimeConvTranspose`` is not ``ConvTranspose1d`` on the same weights: the
JAX module is ``conv_general_dilated`` with ``lhs_dilation=s`` and padding
``k-1-p`` on each side over an unflipped ``(k, C, out)`` kernel, i.e. a
correlation of the zero-stuffed, padded input with that kernel. That
correlation is, term for term, ``F.conv_transpose1d`` (stride s, padding p)
with the kernel flipped along its taps; ``F.conv_transpose1d`` on the
unflipped weights gives another result. The transposed form touches only
the real input positions: the ResidualBlock's up-sampling (k = t_in + 1 =
401 taps from Td_h = 10 positions at T_h = T_p = 100) does 1/40 of the
products of the padded correlation, whose padding is zeros.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .base import flax_truncated_normal_
from .dropout import Dropout
from .embedding import sinusoidal_time_embedding
from .gnn import gnn_conv
from .layers import Conv1d, LayerNorm, Linear, promote

__all__ = ["GraphUNet", "UGnet", "SpatialBlock", "TcnBlock", "ResidualBlock", "TimeConv",
           "TimeConvTranspose", "init_like_flax"]


def _over_time(x, fn):
    """fn over [B*V, C, T] of x [B, V, T, C], back to [B, V, T', C']."""
    B, V, T, C = x.shape
    h = fn(x.reshape(B * V, T, C).transpose(1, 2))
    return h.transpose(1, 2).reshape(B, V, h.shape[-1], h.shape[1])


class TimeConv(nn.Module):
    """Conv over the T axis of [B, V, T, C] with explicit left/right padding."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 pad_left: int = 0, pad_right: int = 0):
        super().__init__()
        self.pad = (pad_left, pad_right)
        self.Conv_0 = Conv1d(in_features, features, kernel_size, stride=stride)

    def forward(self, x):
        return _over_time(x, lambda h: self.Conv_0(F.pad(h, self.pad)))


class TimeConvTranspose(nn.Module):
    """The JAX module's "torch ConvTranspose1d(k, s, p)" over the T axis:
    the input dilated by s, padded k-1-p on each side, correlated with the
    unflipped kernel ``weight [out, in, k]`` (flax's ``(k, in, out)``),
    computed as the transposed convolution of the flipped kernel."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        def fn(h):
            h, w, b = promote(h, self.weight, self.bias)
            # y[t] = sum_j stuffed[t + j - (k-1-p)] w[j]
            #      = sum_{i, j'} x[i] w[k-1-j'] over i*s + j' - p = t
            return F.conv_transpose1d(h, w.flip(-1).transpose(0, 1), b, stride=self.s,
                                      padding=self.p)

        return _over_time(x, fn)


class SpatialBlock(nn.Module):
    """relu(gnn(x, adj)) (ugnet.py:36-45) on [B, V, C] features; the conv is
    named as flax names it (``<ClassName>_0``)."""

    def __init__(self, c_in: int, c_out: int, gnn_name: str = "GCNConv",
                 gnn_param: Optional[dict] = None):
        super().__init__()
        conv = gnn_conv(gnn_name, c_in, c_out, gnn_param)
        self.conv_name = f"{type(conv).__name__}_0"
        self.add_module(self.conv_name, conv)

    def forward(self, x, adj, gen=None):
        return torch.relu(getattr(self, self.conv_name)(x, adj, gen))


class TcnBlock(nn.Module):
    """Causal dilated temporal conv with a residual shortcut (ugnet.py:55-77)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, dilation: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.Conv_0 = Conv1d(c_in, c_out, kernel_size, dilation=dilation)
        self.dropout = Dropout(dropout)
        self.shortcut = Linear(c_in, c_out) if c_in != c_out else None

    def forward(self, x, gen=None):
        h = _over_time(x, lambda h: self.Conv_0(F.pad(h, (self.pad, 0))))
        h = self.dropout(h, gen)
        return h + (x if self.shortcut is None else self.shortcut(x))


class ResidualBlock(nn.Module):
    """2x TCN + timestep injection + down/GNN/up sandwich (ugnet.py:79-133)."""

    def __init__(self, c_in: int, c_out: int, t_in: int, d_h: int, td_h: int, gnn_name: str,
                 gnn_param: Optional[dict] = None, kernel_size: int = 3):
        super().__init__()
        self.td_h = td_h
        self.tcn1 = TcnBlock(c_in, c_out, kernel_size)
        self.t_conv = Linear(d_h, c_out)
        self.tcn2 = TcnBlock(c_out, c_out, kernel_size)
        self.norm = LayerNorm(c_out, eps=1e-5)  # over channels; torch's epsilon
        # T_in -> Td_h (kernel T_in + 1, padding Td_h // 2) and back
        self.downsampling = TimeConv(c_out, c_out, t_in + 1, pad_left=td_h // 2,
                                     pad_right=td_h // 2)
        self.spatial = SpatialBlock(td_h * c_out, td_h * c_out, gnn_name, gnn_param)
        self.upsampling = TimeConvTranspose(c_out, c_out, t_in + 1, 1, td_h // 2)
        self.shortcut = Linear(c_in, c_out) if c_in != c_out else None

    def forward(self, x, temb, adj, gen=None):
        B, V = x.shape[:2]
        h = self.tcn1(x, gen)
        h = h + self.t_conv(temb)[:, None, None, :]
        h = self.norm(self.tcn2(h, gen))
        h = self.downsampling(h)  # [B, V, Td_h, c_out]
        c_out = h.shape[-1]
        spatial = self.spatial(h.reshape(B, V, self.td_h * c_out), adj, gen)
        h = self.upsampling(spatial.reshape(B, V, self.td_h, c_out))
        return h + (x if self.shortcut is None else self.shortcut(x))


class Downsample(nn.Module):
    """Stride-2 time conv: T -> floor((T-1)/2)+1 (ugnet.py:149-157)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.conv = TimeConv(c_in, c_in, 3, stride=2, pad_left=1, pad_right=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Transposed stride-2 time conv: T -> 2T (ugnet.py:168-176)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.conv = TimeConvTranspose(c_in, c_in, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class GraphUNet(nn.Module):
    """The down / middle / up trunk of residual blocks shared by DiffSTG's
    ``UGnet`` and NsDiff_spatial's denoiser (ugnet.py:192-295): the channel
    multipliers define the resolutions, the up path's skip connections pop
    the down path's stack, and every block sits under its flax name
    (``down_<i>``, ``middle_1``, ``middle_2``, ``up_<i>``)."""

    def _build_trunk(self, d_h: int, td_h: int, gnn_name: str, gnn_param: Optional[dict],
                     mults: Sequence[int], n_blocks: int, t_in: int, halve) -> int:
        """Register the blocks for input width ``d_h`` over ``t_in`` steps;
        ``halve(t)`` is the step count a Downsample leaves as its caller
        counts it. Returns the time length after the up path."""
        n_res = len(mults)

        def block(name, c_in, c_out, t):
            self.add_module(name, ResidualBlock(c_in, c_out, t, d_h, td_h, gnn_name,
                                                gnn_param))

        stack = [d_h]  # the channels of the skip stack
        in_ch = out_ch = d_h
        bi = 0
        self.down = []  # (name, kind) in call order
        for i in range(n_res):
            out_ch = in_ch * mults[i]
            for _ in range(n_blocks):
                block(f"down_{bi}", in_ch, out_ch, t_in)
                self.down.append((f"down_{bi}", "res"))
                stack.append(out_ch)
                in_ch = out_ch
                bi += 1
            if i < n_res - 1:
                self.add_module(f"down_{bi}", Downsample(in_ch))
                self.down.append((f"down_{bi}", "sample"))
                stack.append(in_ch)
                t_in = halve(t_in)
                bi += 1
        block("middle_1", out_ch, out_ch, t_in)
        block("middle_2", out_ch, out_ch, t_in)

        in_ch = out_ch
        bi = 0
        self.up = []
        for i in reversed(range(n_res)):
            out_ch = in_ch
            for _ in range(n_blocks):
                block(f"up_{bi}", in_ch + stack.pop(), out_ch, t_in)
                self.up.append((f"up_{bi}", "res"))
                in_ch = out_ch
                bi += 1
            out_ch = in_ch // mults[i]
            block(f"up_{bi}", in_ch + stack.pop(), out_ch, t_in)
            self.up.append((f"up_{bi}", "res"))
            in_ch = out_ch
            bi += 1
            if i > 0:
                self.add_module(f"up_{bi}", Upsample(in_ch))
                self.up.append((f"up_{bi}", "sample"))
                t_in = t_in * 2
                bi += 1
        return t_in

    def _trunk(self, hx, temb, adj, gen=None):
        stack = [hx]
        for name, kind in self.down:
            mod = getattr(self, name)
            hx = mod(hx, temb, adj, gen) if kind == "res" else mod(hx)
            stack.append(hx)
        hx = self.middle_1(hx, temb, adj, gen)
        hx = self.middle_2(hx, temb, adj, gen)
        for name, kind in self.up:
            mod = getattr(self, name)
            if kind == "res":
                hx = mod(torch.cat([hx, stack.pop()], dim=-1), temb, adj, gen)
            else:
                hx = mod(hx)
        return hx


class UGnet(GraphUNet):
    """(x_t, t, x_masked, adj) -> eps prediction, all [B, V, T, F]
    (ugnet.py:192-295): x and x_masked concatenated on the time axis (2T)."""

    def __init__(self, d_h: int, T_h: int, T_p: int, F: int,
                 channel_multipliers: Sequence[int] = (1, 2), n_blocks: int = 2,
                 gnn_name: str = "GCNConv", gnn_param: Optional[dict] = None, td_h: int = 10):
        super().__init__()
        self.d_h = d_h
        T = T_h + T_p
        self.x_proj = Linear(F, d_h)
        t_out = self._build_trunk(d_h, td_h, gnn_name, gnn_param, tuple(channel_multipliers),
                                  n_blocks, 2 * T, lambda t: (t - 1) // 2 + 1)
        if t_out != 2 * T:
            raise ValueError(f"the time axis must round-trip to 2T = {2 * T}, got {t_out}")
        self.out_proj = Linear(d_h, F)
        # Linear over the time axis 2T -> T (ugnet.py:246-247); flax's layout
        # [T, 2T], not a Dense kernel
        self.out_time_kernel = nn.Parameter(torch.empty(T, 2 * T))
        self.out_time_bias = nn.Parameter(torch.zeros(T))

    def forward(self, x, t, x_masked, adj, gen=None):
        hx = self.x_proj(torch.cat([x, x_masked], dim=2))  # [B, V, 2T, d_h]
        # the token's type: a float32 temb would promote every residual, and
        # all layers after it, back to float32 in bf16 sampling
        temb = sinusoidal_time_embedding(t, self.d_h).to(hx.dtype)
        e = self.out_proj(self._trunk(hx, temb, adj, gen))  # [B, V, 2T, F]
        w, e, b = promote(self.out_time_kernel, e, self.out_time_bias)
        return torch.einsum("ot,bvtf->bvof", w, e) + b[None, None, :, None]


@torch.no_grad()
def init_like_flax(module: nn.Module) -> None:
    """Flax's default initialisers for the UGnet's leaves, from the global
    stream: Dense, Conv and the transposed conv's kernels lecun-normal
    (truncated at two standard deviations, fan-in = in x taps), GRU hidden
    kernels orthogonal, attention vectors glorot-uniform (drawn at
    construction), ``out_time_kernel`` lecun-normal over its fan-in T, biases
    zero, LayerNorm scale one."""

    def lecun(w, fan_in):
        flax_truncated_normal_(w, fan_in, 1.0)

    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            if name.rpartition(".")[2] in ("hr", "hz", "hn"):
                nn.init.orthogonal_(m.weight)
            else:
                lecun(m.weight, m.in_features)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            lecun(m.weight, m.in_channels * m.kernel_size[0])
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, TimeConvTranspose):
            lecun(m.weight, m.weight.shape[1] * m.weight.shape[2])
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GraphUNet):
            lecun(m.out_time_kernel, m.out_time_kernel.shape[0])
            m.out_time_bias.zero_()
