"""NsDiff_spatial — the graph variant of NsDiff.

Counterpart of ``upgdm_tpu/models/nsdiff_spatial.py`` (reference
NsDiff/ugnet.py:194-292, mu_backbone.py:186-346, NsDiff_model.py:496-801).
Graph batches are dense, [B, V, T, F] with an adjacency [V, V] or
[B, V, V]; per-node sequences flatten to [B*V, T, F] for the transformer
and g(x), and fold back for the message passing.

  - f(x) is ``NSTransformerSpatial``: the NS-Transformer whose encoder output
    goes through a Conv-down (T -> fT_h) -> GNN over the nodes -> Conv-up
    sandwich before the decoder.
  - g(x) is the flat ``SigmaEstimation`` over the node sequences.
  - The denoiser is ``NsDiffSpatialUGnet``, a graph U-Net conditioned on
    concat(y_t, y0_hat, gx) with eps and sigma heads; the reverse chain is
    the flat model's ``nsdiff_p_sample_loop``, its S members run as one
    batch of S*B graphs (the JAX package's ``vmap``).

Unlike the flat model, every stage holds all three modules (the JAX
package's ``_init_params`` builds them whatever ``train_model_select`` is):
a pretrain stage's checkpoint carries the same keys as JAX's, and
``trainable_mask`` picks what a stage trains. In bf16 sampling the
denoiser's weights, its inputs and the dense adjacency are cast (the GCN's
degree normalisation runs in bf16, as in JAX); f(x), g(x), the chain state
and the posterior stay float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops import diffusion as D
from ..ops.rolling import wv_sigma_trailing
from ..parallel import draws
from .base import EPS
from .embedding import sinusoidal_time_embedding
from .layers import Linear, promote
from .ns_transformer import NSTransformer
from .nsdiff import NsDiffModel
from .sigma_estimation import SigmaEstimation
from .ugnet import GraphUNet, SpatialBlock, TimeConv, TimeConvTranspose, init_like_flax

__all__ = ["NsDiffSpatialUGnet", "NSTransformerSpatial", "NsDiffSpatialModel"]


class NsDiffSpatialUGnet(GraphUNet):
    """(y_t, y0_hat, gx, t, adj) -> (eps, sigma), each [B, V, T_p, F]."""

    def __init__(self, d_h: int, pred_len: int, F: int,
                 channel_multipliers: Sequence[int] = (1, 2), n_blocks: int = 2,
                 gnn_name: str = "GCNConv", gnn_param: Optional[dict] = None, td_h: int = 10):
        super().__init__()
        self.d_h = d_h
        T = pred_len
        self.x_proj = Linear(3 * F, d_h)
        t_out = self._build_trunk(d_h, td_h, gnn_name, gnn_param, tuple(channel_multipliers),
                                  n_blocks, T, lambda t: t // 2)
        if t_out != T:
            raise ValueError(f"the time axis must round-trip to pred_len = {T}, got {t_out}")
        self.out_proj = Linear(d_h, d_h)
        # Dense over the time axis T -> T; flax's layout [T_out, T_in]
        self.out_time_kernel = torch.nn.Parameter(torch.empty(T, T))
        self.out_time_bias = torch.nn.Parameter(torch.zeros(T))
        self.lin4 = Linear(d_h, F)
        self.sigma_lin = Linear(F, F)

    def forward(self, y_t, y_0_hat, g_x, t, adj, gen=None):
        hx = self.x_proj(torch.cat([y_t, y_0_hat, g_x], dim=-1))  # [B, V, T, d_h]
        # the token's type keeps bf16 sampling bf16 end to end
        temb = sinusoidal_time_embedding(t, self.d_h).to(hx.dtype)
        h = self.out_proj(self._trunk(hx, temb, adj, gen))
        w, h, b = promote(self.out_time_kernel, h, self.out_time_bias)
        h = torch.einsum("ot,bvtf->bvof", w, h) + b[None, None, :, None]
        eps_pred = self.lin4(h)
        sigma = F.softplus(self.sigma_lin(F.softplus(eps_pred)))
        return eps_pred, sigma


class NSTransformerSpatial(NSTransformer):
    """f(x) with GNN message passing on the encoder output
    (mu_backbone.py:186-346): x [B, V, T, F] + adj -> (pred [B, V, pred_len,
    F], dec_out [B, V, L+P, F]). ``gen`` turns dropout on."""

    def __init__(self, seq_len, label_len, pred_len, enc_in, d_model=64, n_heads=4,
                 e_layers=2, d_layers=1, d_ff=128, dropout=0.05, activation="gelu",
                 p_hidden_dims=(64, 64), p_hidden_layers=2, spatial_layers=1, fT_h=10,
                 f_gnn_name="GCNConv", f_gnn_param=None):
        super().__init__(seq_len, label_len, pred_len, enc_in, d_model, n_heads, e_layers,
                         d_layers, d_ff, dropout, activation, p_hidden_dims, p_hidden_layers)
        self.d_model, self.fT_h, self.spatial_layers = d_model, fT_h, spatial_layers
        # T -> fT_h (kernel T + 1, padding fT_h // 2) and back
        self.downsampling = TimeConv(d_model, d_model, seq_len + 1, pad_left=fT_h // 2,
                                     pad_right=fT_h // 2)
        for l in range(spatial_layers):
            setattr(self, f"spatial_{l}", SpatialBlock(fT_h * d_model, fT_h * d_model,
                                                        f_gnn_name, f_gnn_param))
        self.upsampling = TimeConvTranspose(d_model, d_model, seq_len + 1, 1, fT_h // 2)

    def forward(self, x, adj, gen=None):
        B, V, T, Fdim = x.shape
        enc, ctx = self.encode(x.reshape(B * V, T, Fdim), gen)
        enc4 = self.downsampling(enc.reshape(B, V, T, self.d_model))  # [B, V, fT_h, d]
        spatial = enc4.reshape(B, V, self.fT_h * self.d_model)
        for l in range(self.spatial_layers):
            spatial = getattr(self, f"spatial_{l}")(spatial, adj, gen)
        enc4 = self.upsampling(spatial.reshape(B, V, self.fT_h, self.d_model))
        dec_out = self.decode(enc4.reshape(B * V, T, self.d_model), ctx, gen)
        pred = dec_out[:, -self.pred_len:, :].reshape(B, V, self.pred_len, Fdim)
        return pred, dec_out.reshape(B, V, -1, Fdim)


class NsDiffSpatialModel(NsDiffModel):
    """Graph NsDiff (NsDiff_model.py:496-790) on dense batches
    [B, V, windows + pred_len, F] with adjacency; weights are random from
    ``seed`` until loaded. ``train_model_select`` picks the stage of
    ``loss_fn`` and ``trainable_mask``; ``load_pretrain`` (with
    ``load_pretrain_f``) takes g(x) (and f(x)) from the stage directories,
    as the flat model does."""

    scaler_axis = (0, 1)  # stats over (windows * nodes, time)

    def _build_modules(self) -> None:
        p = self.net_param
        f = NSTransformerSpatial(
            seq_len=self.seq_len,
            label_len=self.label_len,
            pred_len=self.pred_len,
            enc_in=self.dataset_nf,
            d_model=p.get("d_model", 64),
            n_heads=p.get("n_heads", 4),
            e_layers=p.get("e_layers", 2),
            d_layers=p.get("d_layers", 1),
            d_ff=p.get("d_ff", 128),
            dropout=p.get("dropout", 0.05),
            activation=p.get("activation", "gelu"),
            p_hidden_dims=tuple(p.get("p_hidden_dims", (64, 64))),
            p_hidden_layers=p.get("p_hidden_layers", 2),
            spatial_layers=p.get("spatial_layers", 1),
            fT_h=p.get("fT_h", 10),
            f_gnn_name=p.get("f_gnn_name", "GCNConv"),
            f_gnn_param=p.get("f_gnn_param"),
        )
        g = SigmaEstimation(self.windows, self.pred_len, self.dataset_nf, 512,
                            self.rolling_length)
        den = NsDiffSpatialUGnet(
            d_h=p.get("d_h", 4),
            pred_len=self.pred_len,
            F=self.dataset_nf,
            channel_multipliers=tuple(p.get("channel_multipliers", (1, 2))),
            n_blocks=p.get("n_blocks", 2),
            gnn_name=p.get("gnn_name", "GCNConv"),
            gnn_param=p.get("gnn_param"),
            td_h=p.get("Td_h", 10),
        )
        self.net["cond_pred_model"], self.net["cond_pred_model_g"], self.net["model"] = f, g, den
        # flax's initialisers: the NS-Transformer's (he-normal token conv) and
        # g(x)'s, the graph blocks' lecun-normal convs
        self.init_like_flax(f)
        self.init_like_flax(g)
        for l in range(f.spatial_layers):
            init_like_flax(getattr(f, f"spatial_{l}"))
        init_like_flax(f.downsampling)
        init_like_flax(f.upsampling)
        init_like_flax(den)

    # ------------------------------------------------------------------
    def _apply_f(self, batch_x, adj, gen=None):
        return self.net["cond_pred_model"](batch_x, adj, gen)[0]

    def _apply_g_nodes(self, batch_x):
        """g(x) over the node sequences: [B, V, T, F] -> [B, V, O, F]."""
        B, V = batch_x.shape[:2]
        gx = self.net["cond_pred_model_g"](batch_x.reshape(B * V, self.windows, self.dataset_nf))
        return gx.reshape(B, V, self.pred_len, self.dataset_nf)

    def _adj(self, adj):
        """A numpy or tensor adjacency on the model's device; a float32 one
        (a bf16 one from ``cast_loss`` keeps its type)."""
        adj = torch.as_tensor(adj, device=self.device)
        return adj if adj.dtype == torch.bfloat16 else adj.float()

    def loss_fn(self, batch, adj, select: Optional[str] = None, train: bool = True,
                generator: Optional[torch.Generator] = None, t=None, noise=None):
        """training_step / pretrain_f / pretrain_g on a dense graph batch
        [B, V, windows + pred_len, F] with ``adj`` [B, V, V] or [V, V]
        (NsDiff_model.py:599-694): the trailing variance over the [B*V, W+P,
        F] node rows, antithetic timesteps, and ``freeze_pretrain`` leaving
        only the KL term. ``train`` turns dropout on; draws come from
        ``generator`` (default the model's). ``t`` [B] and ``noise`` [B, V,
        pred_len, F] (the standard normal before its scaling) are test
        seams."""
        select = select or self.train_model_select
        gen = generator if generator is not None else self.generator
        drop = gen if train else None
        batch = self.as_batch(batch)
        adj = self._adj(adj)
        batch_x = batch[:, :, : self.windows, :]
        batch_y = batch[:, :, self.windows : self.windows + self.pred_len, :]
        B, V = batch_x.shape[:2]
        if select == "pretrain_f":
            return torch.mean((self._apply_f(batch_x, adj, drop) - batch_y) ** 2)
        flat_xy = torch.cat([batch_x, batch_y], dim=2).reshape(B * V, -1, self.dataset_nf)
        y_sigma = wv_sigma_trailing(flat_xy, self.rolling_length)[:, -self.pred_len :, :]
        y_sigma = y_sigma.reshape(B, V, self.pred_len, self.dataset_nf) + EPS
        if select == "pretrain_g":
            gx = self._apply_g_nodes(batch_x)
            return torch.mean((torch.sqrt(gx) - torch.sqrt(y_sigma)) ** 2)

        sched = self._sched_dev
        if t is None:
            t = self.antithetic_t(B, sched.num_timesteps, gen)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        y0_hat = self._apply_f(batch_x, adj, drop)
        gx = self._apply_g_nodes(batch_x) + EPS
        loss1 = torch.mean((y0_hat - batch_y) ** 2)
        loss2 = torch.mean((torch.sqrt(gx) - torch.sqrt(y_sigma)) ** 2)
        e = (draws.randn(batch_y.shape, gen, device=self.device, dtype=batch_y.dtype)
             if noise is None else torch.as_tensor(noise, dtype=batch_y.dtype, device=self.device))
        c = D.nsdiff_gather(sched, t, batch_y)
        y_t = D.nsdiff_q_sample(batch_y, y0_hat, sched, t,
                                e * torch.sqrt(D.nsdiff_forward_noise(c, gx, y_sigma)))
        output, sigma_theta = self.net["model"](y_t, y0_hat, gx, t, adj, drop)
        ratio = D.nsdiff_sigma_tilde(c, gx, y_sigma) / (sigma_theta + EPS)
        kl = torch.mean((e - output) ** 2) + torch.mean(ratio) - torch.mean(torch.log(ratio))
        if self.net_param.get("freeze_pretrain", False):
            return kl
        return kl + loss1 + loss2

    @torch.inference_mode()
    def sample_fn(self, batch_x, adj, generator=None, n_z_samples: Optional[int] = None,
                  use_gx_directly: bool = False, noise=None):
        """Ensemble [B, V, pred_len, F, S] for batch_x [B, V, W, F]
        (NsDiff_model.py:695-790). ``noise`` (test seam): T arrays [S, B, V,
        pred_len, F], z_T first."""
        S = n_z_samples or self.n_z_samples
        batch_x = self.as_batch(batch_x)
        adj = self._adj(adj)
        y0_hat = self._apply_f(batch_x, adj)
        gx = self._apply_g_nodes(batch_x) + EPS
        B = batch_x.shape[0]
        shape = (S * B,) + tuple(y0_hat.shape[1:])
        y0_rows = y0_hat[None].expand(S, *y0_hat.shape).reshape(shape)
        gx_rows = gx[None].expand(S, *gx.shape).reshape(shape)

        in_dt = self.sampling_dtype()
        den = self._cast("model", in_dt)
        y0_n, gx_n = y0_rows.to(in_dt), gx_rows.to(in_dt)
        adj_n = adj.to(in_dt)
        if adj_n.ndim == 3:  # one adjacency per graph of the batch, for every member
            adj_n = adj_n[None].expand(S, *adj_n.shape).reshape(S * B, *adj_n.shape[1:])

        def model_fn(y, t):
            tb = torch.full((S * B,), t, dtype=torch.long, device=self.device)
            eps, sig = den(y.to(in_dt), y0_n, gx_n, tb, adj_n)
            return eps.float(), sig.float()

        if noise is not None:
            noise = [torch.as_tensor(z, dtype=torch.float32, device=self.device).reshape(shape)
                     for z in noise]
        samples = D.nsdiff_p_sample_loop(
            model_fn, y0_rows, gx_rows, self.sched,
            generator=generator if generator is not None else self.generator,
            use_gx_directly=use_gx_directly, noise=noise)
        return samples.reshape(S, *y0_hat.shape).permute(1, 2, 3, 4, 0)

    def evaluation_step(self, gdata, use_gx_directly: bool = False):
        """gdata: {x: [V, T(+O), F], adj: [V, V]} -> (samples [V, O, F, S],
        the future [V, O, F] or None)."""
        x = self.as_batch(gdata["x"])
        batch_y = (x[:, self.windows : self.windows + self.pred_len, :]
                   if x.shape[1] - self.windows >= self.pred_len else None)
        outs = self.sample_fn(x[None, :, : self.windows, :], gdata["adj"], self.generator,
                              self.n_z_samples, use_gx_directly)
        return outs[0], batch_y

    @torch.inference_mode()
    def gx_fn(self, batch_x):
        """g(x) of one graph [V, T, F] -> [V, O, F] or of a batch [B, V, T,
        F] -> [B, V, O, F]."""
        batch_x = self.as_batch(batch_x)
        if batch_x.ndim == 3:
            return self.net["cond_pred_model_g"](batch_x)
        return self._apply_g_nodes(batch_x)

    # -- reference surface: the stage's loss, dropout off ----------------------
    @torch.no_grad()
    def training_step(self, batch, adj):
        return self.loss_fn(batch, adj, train=False)

    @torch.no_grad()
    def pretrain_f(self, batch, adj):
        return self.loss_fn(batch, adj, "pretrain_f", train=False)

    @torch.no_grad()
    def pretrain_g(self, batch, adj):
        return self.loss_fn(batch, adj, "pretrain_g", train=False)
