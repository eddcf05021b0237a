"""Non-stationary Transformer: NsDiff's mean head f(x) and TMDM's
VAE-regularised conditional predictor.

Counterpart of ``Projector``, the encoder/decoder layers, ``NSTransformer``
and ``NSTransformerVAE`` in ``upgdm_tpu/models/ns_transformer.py``. Submodules are
named after flax's auto-names (``Dense_0``, ``LayerNorm_1``,
``NSEncoderLayer_0``, ...) so that ``utils/weights.py`` maps checkpoints with
transposes only. Dropout sits where the JAX package puts it (attention
weights, both residual branches, both FFN denses, the embeddings) and is
active only when a generator is passed (flax's ``deterministic=False``).

Numerics kept from the JAX package: ``"gelu"`` is flax's tanh approximation,
LayerNorm epsilon is 1e-6, the per-series std is a population std with 1e-5
inside the sqrt, and the Projector reads the raw history, not the normalised
one.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AttentionLayer
from .dropout import Dropout
from .embedding import DataEmbedding
from .sigma_estimation import LN_EPS

__all__ = ["Projector", "NSEncoder", "NSDecoder", "NSTransformer", "NSTransformerVAE"]


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # flax nn.gelu default
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


class Projector(nn.Module):
    """MLP learning the de-stationary factors tau/delta.

    x: [B, S, E]; stats: [B, 1, E] -> [B, output_dim].
    """

    def __init__(self, seq_len: int, enc_in: int, hidden_dims: Sequence[int],
                 hidden_layers: int, output_dim: int, kernel_size: int = 3):
        super().__init__()
        self.pad = kernel_size // 2
        # Conv1d(in=S, out=1, circular along E) kept as a bare parameter so
        # its name matches flax's series_conv_kernel; torch layout [1, S, k]
        self.series_conv_kernel = nn.Parameter(torch.zeros(1, seq_len, kernel_size))
        dims = list(hidden_dims)
        layers = [nn.Linear(2 * enc_in, dims[0])]
        for i in range(hidden_layers - 1):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
        layers.append(nn.Linear(dims[hidden_layers - 1], output_dim, bias=False))
        self.n_dense = len(layers)
        for i, layer in enumerate(layers):
            setattr(self, f"Dense_{i}", layer)

    def forward(self, x, stats):
        B = x.shape[0]
        padded = F.pad(x, (self.pad, self.pad), mode="circular")
        out = F.conv1d(padded, self.series_conv_kernel.to(x.dtype))  # [B, 1, E]
        h = torch.cat([out, stats], dim=1).reshape(B, -1)
        for i in range(self.n_dense - 1):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n_dense - 1}")(h)


class NSEncoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, n_heads, dropout=0.05, activation="gelu"):
        super().__init__()
        self.AttentionLayer_0 = AttentionLayer(d_model, n_heads, False, dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)
        self.act = _act(activation)

    def forward(self, x, tau=None, delta=None, gen=None):
        drop = lambda h: self.dropout(h, gen)
        x = self.LayerNorm_0(
            x + drop(self.AttentionLayer_0(x, x, x, tau=tau, delta=delta, gen=gen)))
        y = drop(self.Dense_1(drop(self.act(self.Dense_0(x)))))
        return self.LayerNorm_1(x + y)


class NSEncoder(nn.Module):
    def __init__(self, e_layers, d_model, d_ff, n_heads, dropout=0.05, activation="gelu"):
        super().__init__()
        self.n_layers = e_layers
        for i in range(e_layers):
            setattr(self, f"NSEncoderLayer_{i}",
                    NSEncoderLayer(d_model, d_ff, n_heads, dropout, activation))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, tau=None, delta=None, gen=None):
        for i in range(self.n_layers):
            x = getattr(self, f"NSEncoderLayer_{i}")(x, tau=tau, delta=delta, gen=gen)
        return self.LayerNorm_0(x)


class NSDecoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, n_heads, dropout=0.05, activation="gelu"):
        super().__init__()
        self.self_attn = AttentionLayer(d_model, n_heads, True, dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = AttentionLayer(d_model, n_heads, False, dropout)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self.LayerNorm_2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)
        self.act = _act(activation)

    def forward(self, x, cross, tau=None, delta=None, gen=None):
        drop = lambda h: self.dropout(h, gen)
        # causal self-attention gets no delta; only cross attention does
        # (its length matches the encoder sequence)
        x = self.LayerNorm_0(x + drop(self.self_attn(x, x, x, tau=tau, delta=None, gen=gen)))
        x = self.LayerNorm_1(
            x + drop(self.cross_attn(x, cross, cross, tau=tau, delta=delta, gen=gen)))
        y = drop(self.Dense_1(drop(self.act(self.Dense_0(x)))))
        return self.LayerNorm_2(x + y)


class NSDecoder(nn.Module):
    def __init__(self, d_layers, d_model, d_ff, n_heads, c_out, dropout=0.05, activation="gelu"):
        super().__init__()
        self.n_layers = d_layers
        for i in range(d_layers):
            setattr(self, f"NSDecoderLayer_{i}",
                    NSDecoderLayer(d_model, d_ff, n_heads, dropout, activation))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, c_out)

    def forward(self, x, cross, tau=None, delta=None, gen=None):
        for i in range(self.n_layers):
            x = getattr(self, f"NSDecoderLayer_{i}")(x, cross, tau=tau, delta=delta, gen=gen)
        return self.Dense_0(self.LayerNorm_0(x))


def _series_stats(x_enc):
    """Per-series mean and population std (+1e-5 inside the sqrt)."""
    mean_enc = x_enc.mean(dim=1, keepdim=True)
    std_enc = torch.sqrt((x_enc - mean_enc).var(dim=1, keepdim=True, correction=0) + 1e-5)
    return mean_enc, std_enc


class NSTransformer(nn.Module):
    """x_enc [B, S, F] -> (pred [B, pred_len, F], dec_out [B, L+P, F]).

    The decoder input is the last label_len of the normalised history
    followed by zeros. ``gen`` (a ``torch.Generator``) turns dropout on.
    """

    def __init__(self, seq_len, label_len, pred_len, enc_in, d_model=512, n_heads=8,
                 e_layers=2, d_layers=1, d_ff=256, dropout=0.05, activation="gelu",
                 p_hidden_dims=(64, 64), p_hidden_layers=2):
        super().__init__()
        self.label_len = label_len
        self.pred_len = pred_len
        self.enc_in = enc_in
        self.tau_learner = Projector(seq_len, enc_in, p_hidden_dims, p_hidden_layers, 1)
        self.delta_learner = Projector(seq_len, enc_in, p_hidden_dims, p_hidden_layers, seq_len)
        self.enc_embedding = DataEmbedding(enc_in, d_model, dropout)
        self.encoder = NSEncoder(e_layers, d_model, d_ff, n_heads, dropout, activation)
        self.dec_embedding = DataEmbedding(enc_in, d_model, dropout)
        self.decoder = NSDecoder(d_layers, d_model, d_ff, n_heads, enc_in, dropout, activation)

    def encode(self, x_enc, gen=None):
        """(enc [B, S, d], ctx): the encoder output and what ``decode`` needs."""
        x_raw = x_enc
        mean_enc, std_enc = _series_stats(x_enc)
        x_norm = (x_enc - mean_enc) / std_enc
        x_dec = torch.cat(
            [
                x_norm[:, -self.label_len:, :],
                x_enc.new_zeros(x_enc.shape[0], self.pred_len, self.enc_in),
            ],
            dim=1,
        )
        tau = torch.exp(self.tau_learner(x_raw, std_enc))
        delta = self.delta_learner(x_raw, mean_enc)
        enc = self.encoder(self.enc_embedding(x_norm, gen), tau=tau, delta=delta, gen=gen)
        return enc, (x_dec, tau, delta, mean_enc, std_enc)

    def decode(self, enc, ctx, gen=None):
        """dec_out [B, L+P, F] in the raw scale of x_enc."""
        x_dec, tau, delta, mean_enc, std_enc = ctx
        dec_out = self.decoder(self.dec_embedding(x_dec, gen), enc, tau=tau, delta=delta,
                               gen=gen)
        return dec_out * std_enc + mean_enc

    def forward(self, x_enc, gen=None):
        enc, ctx = self.encode(x_enc, gen)
        dec_out = self.decode(enc, ctx, gen)
        return dec_out[:, -self.pred_len:, :], dec_out


class NSTransformerVAE(NSTransformer):
    """TMDM's conditional predictor with a VAE latent z between encoder and
    decoder (tmdm_ns_transformer.py:40-174).

    x_enc [B, S, F] -> (pred, dec_out, kl_z, z_sample); dec_out spans
    label_len + pred_len and is the y0_hat TMDM conditions on. In
    deterministic mode (sampling) z_sample is z_mean; otherwise it is
    reparameterised with the mean of ``n_reparam_samples`` normals drawn
    from ``generator``, or with ``reparam_eps`` (that mean, shaped like
    z_mean: a test seam). ``gen`` turns dropout on, as in ``NSTransformer``
    (the training loss passes both).
    """

    def __init__(self, seq_len, label_len, pred_len, enc_in, d_model=64, n_heads=4,
                 e_layers=2, d_layers=1, d_ff=128, dropout=0.05, activation="gelu",
                 p_hidden_dims=(64, 64), p_hidden_layers=2, n_reparam_samples=100):
        super().__init__(seq_len, label_len, pred_len, enc_in, d_model, n_heads, e_layers,
                         d_layers, d_ff, dropout, activation, p_hidden_dims, p_hidden_layers)
        self.n_reparam_samples = n_reparam_samples
        for name in ("z_mean", "z_logvar", "z_out"):
            for i in (0, 1):
                setattr(self, f"{name}_{i}", nn.Linear(d_model, d_model))

    def _mlp(self, name, h):
        return getattr(self, f"{name}_1")(F.relu(getattr(self, f"{name}_0")(h)))

    def forward(self, x_enc, deterministic: bool = True, generator=None, reparam_eps=None,
                gen=None):
        enc, ctx = self.encode(x_enc, gen)
        z_mean = self._mlp("z_mean", enc)
        z_logvar = self._mlp("z_logvar", enc)
        if deterministic:
            z_sample = z_mean
        else:  # mean + sqrt(var) * eps_bar, eps_bar ~ N(0, 1/n)
            eps = reparam_eps
            if eps is None:
                eps = torch.randn((self.n_reparam_samples,) + z_mean.shape, generator=generator,
                                  device=z_mean.device).mean(dim=0)
            z_sample = z_mean + torch.sqrt(torch.exp(z_logvar)) * eps.to(z_mean.dtype)
        kl_z = torch.mean(
            -0.5 * torch.mean(1 - z_mean ** 2 + z_logvar - torch.exp(z_logvar), dim=1))
        dec_out = self.decode(self._mlp("z_out", z_sample), ctx, gen)
        return dec_out[:, -self.pred_len:, :], dec_out, kl_z, z_sample
