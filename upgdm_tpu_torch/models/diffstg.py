"""DiffSTG — masked graph spatio-temporal DDPM.

Counterpart of ``upgdm_tpu/models/diffstg.py`` (reference
graph_diffusion_model.py:13-282). Graph batches are dense, [B, V, T, F]
with an adjacency [B, V, V] or [V, V] (padded to a common V, with a node
mask for the loss), and the denoiser is ``UGnet``.

Sampling walks the static (t1, t2) pairs of the inference schedule. Every
posterior step, DDPM or DDIM, is affine, x_next = a x_t + b eps + c z, so the
pairs fold into one float32 [steps, 4] table (t1, a, b, c) computed from the
float64 schedule; the S ensemble members run as one batch of S graphs (the
JAX package's ``vmap``). Each member draws its x_T and a z at every step,
also where c = 0, as the JAX package does. The UGnet runs in
``sampling_dtype`` (default bf16: weights and inputs cast, t float32); the
chain state, the coefficients and the draws stay float32.

Draws come from an explicit ``torch.Generator`` (the model's by default);
``sample_fn`` and ``loss_fn`` take the draws as optional arguments (test
seams), so a test hands the port the normals, timesteps and mask draws JAX
drew from its keys.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import diffusion as D
from ..ops.schedules import diffstg_schedule, inference_time_pairs
from ..parallel import draws
from .base import DiffusionWrapperBase
from .ugnet import UGnet, init_like_flax

__all__ = ["DiffSTGModel"]


def _log_norm_pdf(x, mu=0.0, sigma=1.0):
    """Log-normal pdf (diffusion_schedulers.py:11-37), numpy host side."""
    x = np.asarray(x, np.float64)
    sigma = max(sigma, 1e-8)
    pdf = np.zeros_like(x)
    m = x > 0
    logx = np.log(x[m])
    pdf[m] = np.exp(-0.5 * ((logx - mu) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi) * x[m])
    return pdf


class DiffSTGModel(DiffusionWrapperBase):
    """DiffSTG over a UGnet; weights are random from ``seed`` until loaded."""

    scaler_axis = (0, 1)  # graph batches: stats over (windows * nodes, time)

    def __init__(self, net_param: dict, seed: int = 0, device=None, **_):
        net_param = dict(net_param)
        net_param.setdefault("windows", net_param.get("T_h"))
        net_param.setdefault("pred_len", net_param.get("T_p"))
        net_param.setdefault("dataset_nf", net_param.get("F", 1))
        net_param.setdefault("T_h", net_param["windows"])
        net_param.setdefault("T_p", net_param["pred_len"])
        net_param.setdefault("F", net_param["dataset_nf"])
        super().__init__(net_param, seed=seed, device=device)
        p = self.net_param
        self.T_h = p["T_h"]
        self.T_p = p["T_p"]
        self.T = self.T_h + self.T_p
        self.F = p["F"]
        self.mask_ratio = p.get("mask_ratio", 0.0)
        self.diffusion_steps = p["diffusion_steps"]
        self.inference_diffusion_steps = p.get("inference_diffusion_steps", 20)
        self.inference_trick = p.get("inference_trick") or "ddim"
        self.inference_schedule = p.get("inference_schedule", "linear")
        self.loss_weight_schedule = p.get("loss_weight_schedule", "constant")
        self.parallel_sampling = p.get("parallel_sampling", 1)
        self.sequential_sampling = p.get("sequential_sampling", 1)
        self.sched = diffstg_schedule(self.diffusion_steps, p.get("diffusion_schedule", "linear"))
        # weights drawn from `seed` without touching the global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net["model"] = UGnet(
                d_h=p.get("d_h", 4),
                T_h=self.T_h,
                T_p=self.T_p,
                F=self.F,
                channel_multipliers=tuple(p.get("channel_multipliers", (1, 2))),
                n_blocks=p.get("n_blocks", 2),
                gnn_name=p.get("gnn_name", "GCNConv"),
                gnn_param=p.get("gnn_param"),
                td_h=p.get("Td_h", 10),
            )
            init_like_flax(self.net)
        self.net.to(self.device).eval()

    # ------------------------------------------------------------------
    def _loss_weight(self, t_np: np.ndarray) -> np.ndarray:
        if self.loss_weight_schedule == "constant":
            return np.ones_like(t_np, np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):  # snr(0) is inf: weight 0
            return _log_norm_pdf(self.sched.snr(t_np), 0.0, 0.5).astype(np.float32)

    def step_table(self) -> np.ndarray:
        """The static inference walk as float32 rows (t1, a, b, c), from the
        float64 schedule (graph_diffusion_model.py:46-73)."""
        pairs = inference_time_pairs(self.inference_schedule, self.sched.T,
                                     self.inference_diffusion_steps)
        abar, alpha, beta = self.sched.alphabar, self.sched.alpha, self.sched.beta
        rows = []
        for t1, t2 in pairs:
            if self.inference_trick == "ddpm" or t1 <= 1:
                at, atbar, atbar_prev = alpha[t1], abar[t1], abar[t1 - 1]
                beta_tilde = beta[t1 - 1] * (1.0 - atbar_prev) / (1.0 - atbar)
                a = 1.0 / at ** 0.5
                b = -a * (1.0 - at) / (1.0 - atbar) ** 0.5
                c = beta_tilde ** 0.5
            elif self.inference_trick == "ddim":
                atbar, atbar_t = abar[t1], abar[t2]
                a = (atbar_t / atbar) ** 0.5
                b = -a * (1.0 - atbar) ** 0.5 + (1.0 - atbar_t) ** 0.5
                c = 0.0
            else:
                raise ValueError(f"Unknown inference trick {self.inference_trick!r}")
            rows.append((float(t1), a, b, c))
        return np.asarray(rows, np.float32)

    def loss_fn(self, batch, adj, node_mask=None, select: Optional[str] = None,
                train: bool = True, generator: Optional[torch.Generator] = None, t=None,
                noise=None, mask_draw=None):
        """training_step (graph_diffusion_model.py:141-191) on a dense batch
        [B, V, T_h + T_p, F] with ``adj`` [B, V, V] or [V, V] and
        ``node_mask`` [B, V] bool or None (then every node counts).

        ``train`` turns dropout on; draws come from ``generator`` (default
        the model's). ``t`` [B] in 1..T, ``noise`` (shaped like the batch)
        and ``mask_draw`` (the uniforms of the history mask, shaped like the
        history) are test seams, drawn when not given. ``select`` is
        accepted for the training loop's sake and ignored."""
        gen = generator if generator is not None else self.generator
        batch = self.as_batch(batch)
        adj = torch.as_tensor(adj, device=self.device)
        B = batch.shape[0]
        history = batch[:, :, : self.T_h, :]
        future = batch[:, :, self.T_h : self.T, :]
        if self.mask_ratio > 0:
            if mask_draw is None:
                mask_draw = draws.rand(history.shape, gen, device=self.device)
            drop = torch.as_tensor(mask_draw, device=self.device) < self.mask_ratio
            history = torch.where(drop, 0.0, history)
        x0 = torch.cat([batch[:, :, : self.T_h, :], future], dim=2)
        x_masked = torch.cat([history, torch.zeros_like(future)], dim=2)

        # one timestep per graph in 1..T (graph_diffusion_model.py:163-165)
        if t is None:
            t = draws.randint(1, self.sched.T + 1, (B,), gen, device=self.device)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        eps = (draws.randn(x0.shape, gen, dtype=x0.dtype, device=self.device)
               if noise is None else torch.as_tensor(noise, dtype=x0.dtype, device=self.device))
        xt = D.diffstg_q_sample(x0, self.sched, t, eps)
        eps_pred = self.net["model"](xt, t.to(torch.float32), x_masked, adj,
                                     gen if train else None)
        loss_node = ((eps_pred - eps) ** 2).mean(dim=(2, 3))  # [B, V]
        if self.loss_weight_schedule == "constant":
            w = torch.ones(B, dtype=loss_node.dtype, device=self.device)
        else:
            table = torch.as_tensor(self._loss_weight(np.arange(self.sched.T + 1)),
                                    device=self.device)
            w = table[t]
        weighted = loss_node * w[:, None]
        if node_mask is not None:
            node_mask = torch.as_tensor(node_mask, dtype=torch.bool, device=self.device)
            weighted = torch.where(node_mask, weighted, 0.0)
            return weighted.sum() / torch.clamp(node_mask.sum(), min=1)
        return weighted.mean()

    @torch.inference_mode()
    def sample_fn(self, history, adj, generator: Optional[torch.Generator] = None,
                  n_samples: Optional[int] = None, noise=None):
        """Ensemble of denoised x0 for one graph: [V, T, F, S].

        ``history`` [V, T_h, F]; the masked condition is the history and a
        zero future (graph_diffusion_model.py:204-282). ``noise`` (test
        seam): (x_T [S, V, T, F], z [steps, S, V, T, F])."""
        S = n_samples or (self.parallel_sampling * self.sequential_sampling)
        gen = generator if generator is not None else self.generator
        history = self.as_batch(history)
        V = history.shape[0]
        x_masked = torch.cat([history, history.new_zeros(V, self.T_p, self.F)], dim=1)[None]
        adj = torch.as_tensor(adj, dtype=torch.float32, device=self.device)
        adj_b = adj[None] if adj.ndim == 2 else adj
        tab = self.step_table()

        net_dt = self.sampling_dtype()
        net = self._cast("model", net_dt)
        x_m_net = x_masked.to(net_dt).expand(S, V, self.T, self.F)
        adj_net = adj_b.to(net_dt)
        shape = (S, V, self.T, self.F)

        def draw(z):
            if z is not None:
                return torch.as_tensor(z, dtype=torch.float32, device=self.device).reshape(shape)
            return torch.randn(shape, generator=gen, device=self.device)

        x0_noise, zs = noise if noise is not None else (None, [None] * len(tab))
        xt = draw(x0_noise)
        for (t1, a, b, c), z in zip(tab, zs):
            # t stays float32: a bf16 t misrounds timesteps above 256
            t_b = torch.full((S,), float(t1), dtype=torch.float32, device=self.device)
            eps_pred = net(xt.to(net_dt), t_b, x_m_net, adj_net).float()
            xt = float(a) * xt + float(b) * eps_pred + float(c) * draw(z)
        return xt.permute(1, 2, 3, 0)  # [V, T, F, S]

    def evaluation_step(self, gdata):
        """gdata: {x: [V, T, F] or [V, T_h, F], adj: [V, V]} -> (x0 samples
        [V, T, F, parallel x sequential], x0_truth or None)
        (graph_diffusion_model.py:204-282)."""
        x = self.as_batch(gdata["x"])
        history = x[:, : self.T_h, :]
        truth = x[:, : self.T, :] if x.shape[1] - self.T_h >= self.T_p else None
        S = self.parallel_sampling * self.sequential_sampling
        return self.sample_fn(history, gdata["adj"], self.generator, S), truth

    def trainable_mask(self, select=None):
        return {k: True for k in self.net}

    def convert_reference_state_dict(self, flat, strict: bool = True):
        """A reference torch checkpoint (the UGnet under ``model.*`` with
        torch's ``.res``/``.conv`` nesting) as the flax-named flat dict
        (``utils/torch_import.py``); a native dict passes unchanged."""
        if not any(".res.tcn1.conv." in k or k.endswith("x_proj.weight") for k in flat):
            return flat
        from ..utils.torch_import import convert_reference_diffstg_state_dict

        return convert_reference_diffstg_state_dict(flat, self.net_param, strict=strict)

    @torch.no_grad()
    def training_step(self, batch, adj, node_mask=None):
        """The loss on batch, dropout off."""
        return self.loss_fn(batch, adj, node_mask=node_mask, train=False)
