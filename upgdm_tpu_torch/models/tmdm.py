"""TMDM — conditional diffusion steered by a VAE-regularised NS-Transformer.

Counterpart of ``upgdm_tpu/models/tmdm.py``. Sampling: the
conditional predictor (``NSTransformerVAE``, deterministic at sampling time)
runs once per batch and gives ``y_0_hat`` over the label_len + pred_len
target segment; then an S-member ensemble of the T-step CARD reverse chain
runs as one written-out batch of S*B rows (the JAX package's ``vmap``), and
the last pred_len steps are kept.

Denoiser per step:
  - on the card every step goes through the K3 kernel
    (``ops/kernels/fused_tmdm.py``), whatever ``use_pallas_denoiser`` says,
    with matmuls in ``sampling_matmul_dtype`` (default: the
    ``sampling_dtype``, itself bf16 by default) — the JAX package's kernel
    arm; its default flax-in-bf16 arm is XLA code with no kernel to port;
  - on the CPU the plain ``TMDMDenoiser`` runs in ``sampling_dtype``, as the
    JAX package's flax arm does;
  - K3 implements the ``cat_y_pred=True`` input layout only (the default of
    every TMDM config). With ``cat_y_pred=False`` there is no kernel in the
    JAX package either, and the plain module runs on both devices.
The chain state and the posterior arithmetic stay float32 on both.

Training: ``loss_fn`` (tmdm_adapter.py:90-114) is the CARD noise MSE plus
``k_cond`` x (the Gaussian log-likelihood of y_0_hat + ``k_z`` x the VAE's
KL), with autograd through the plain modules; every module trains.
``convert_reference_state_dict`` waits for the checkpoint-import slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import yaml

from ..ops import diffusion as D
from ..ops.kernels.fused_denoiser import check_dtypes, step_weights
from ..ops.kernels.fused_tmdm import fused_tmdm_rows, tmdm_gammas, tmdm_weights
from ..ops.schedules import card_schedule
from .base import DiffusionWrapperBase
from .denoise import TMDMDenoiser
from .embedding import DataEmbedding
from .ns_transformer import NSTransformerVAE

__all__ = ["TMDMModel", "log_normal"]


def log_normal(x, mu, var_scalar: float = 1.0):
    """0.5 * mean(log 2pi + log var + (x-mu)^2/var) (tmdm_adapter.py:13-20)."""
    var = var_scalar + 1e-8
    return 0.5 * torch.mean(math.log(2.0 * math.pi) + math.log(var) + (x - mu) ** 2 / var)


class TMDMModel(DiffusionWrapperBase):
    """TMDM sampler; weights are random from ``seed`` until loaded."""

    def __init__(self, net_param: dict, seed: int = 0, device=None, **_):
        super().__init__(net_param, seed=seed, device=device)
        p = self.net_param
        self.seq_len = p.setdefault("seq_len", self.windows)
        self.label_len = p.setdefault("label_len", self.windows // 2)
        self.diffusion_steps = p.get("diffusion_steps", 100)
        self.n_z_samples = p.get("n_z_samples", 100)
        self.parallel_sample = p.get("parallel_sample", min(10, self.n_z_samples))
        self.k_z = p.get("k_z", 0.01)
        self.k_cond = p.get("k_cond", 1.0)
        self.d_model = p.get("d_model", 64)
        self.target_len = self.label_len + self.pred_len

        # optional tmdm.yml-style config file (TMDM.py:30-40): net_param keys
        # override the yaml's diffusion section
        if p.get("diffusion_config_dir"):
            with open(p["diffusion_config_dir"], "r") as f:
                dcfg = yaml.safe_load(f)
            diff = dcfg.get("diffusion", {})
            p.setdefault("beta_schedule", diff.get("beta_schedule", "linear"))
            p.setdefault("beta_start", diff.get("beta_start", 1e-4))
            p.setdefault("beta_end", diff.get("beta_end", 2e-2))
            model_cfg = dcfg.get("model", {})
            p.setdefault("cat_x", model_cfg.get("cat_x", True))
            p.setdefault("cat_y_pred", model_cfg.get("cat_y_pred", True))

        self.sched = card_schedule(
            p.get("beta_schedule", "linear"),
            self.diffusion_steps,
            p.get("beta_start", 1e-4),
            p.get("beta_end", 2e-2),
        )

        x_embed_dim = p.get("CART_input_x_embed_dim", self.d_model)
        # weights drawn from `seed` without touching the global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net["cond_pred_model"] = NSTransformerVAE(
                seq_len=self.seq_len,
                label_len=self.label_len,
                pred_len=self.pred_len,
                enc_in=self.dataset_nf,
                d_model=self.d_model,
                n_heads=p.get("n_heads", 4),
                e_layers=p.get("e_layers", 2),
                d_layers=p.get("d_layers", 1),
                d_ff=p.get("d_ff", 128),
                dropout=p.get("dropout", 0.05),
                activation=p.get("activation", "gelu"),
                p_hidden_dims=tuple(p.get("p_hidden_dims", (64, 64))),
                p_hidden_layers=p.get("p_hidden_layers", 2),
            )
            self.net["enc_embedding"] = DataEmbedding(self.dataset_nf, x_embed_dim,
                                                      p.get("dropout", 0.05))
            # n_steps = timesteps + 1 (tmdm_model.py:26)
            self.net["model"] = TMDMDenoiser(
                self.dataset_nf,
                self.diffusion_steps + 1,
                cat_x=p.get("cat_x", True),
                cat_y_pred=p.get("cat_y_pred", True),
                x_dim=x_embed_dim,
            )
            self.init_like_flax(self.net)
        self.net.to(self.device).eval()

    # ------------------------------------------------------------------
    @property
    def denoiser(self) -> TMDMDenoiser:
        return self.net["model"]

    @torch.inference_mode()
    def cond_fn(self, batch_x):
        """(y_0_hat [B, L+P, N], x_emb [B, W, d]) float32 for batch_x
        [B, W, N]; the predictor runs in its deterministic mode."""
        batch_x = self.as_batch(batch_x)
        _, y_0_hat, _, _ = self.net["cond_pred_model"](batch_x, deterministic=True)
        return y_0_hat, self.net["enc_embedding"](batch_x)

    def denoiser_fn(self, y0_rows, emb_rows, use_kernel: Optional[bool] = None):
        """``model_fn(y, t) -> eps`` for the reverse chain.

        ``use_kernel=None`` means K3 on the card (``cat_y_pred`` layout) and
        the plain module on the CPU; ``use_kernel=False`` forces the plain
        module (used to hold the kernel path against it on the card).
        """
        d = self.denoiser
        Fdim = y0_rows.shape[-1]
        if use_kernel is None:
            use_kernel = y0_rows.device.type == "cuda" and d.cat_y_pred
        if use_kernel:
            if not d.cat_y_pred:
                raise ValueError("the fused TMDM kernel needs the cat_y_pred=True layout")
            self.sampling_dtype()  # validates sampling_dtype
            mm = self.net_param.get(
                "sampling_matmul_dtype", self.net_param.get("sampling_dtype", "bfloat16"))
            kw = tmdm_weights(d)
            if y0_rows.is_cuda:  # laid out once for the chain's launches
                kw = step_weights(kw, check_dtypes(mm, "float32"))
            # x = [y_t, y0_hat] rows; the y0_hat columns are written once
            x = torch.empty(y0_rows.numel() // Fdim, 2 * Fdim, device=y0_rows.device)
            x[:, Fdim:] = y0_rows.reshape(-1, Fdim)

            def model_fn(y, t):
                x[:, :Fdim] = y.reshape(-1, Fdim)
                return fused_tmdm_rows(x, tmdm_gammas(d, t), kw, matmul_dtype=mm).reshape(y.shape)

            return model_fn

        in_dt = self.sampling_dtype()
        den = self._cast("model", in_dt)
        y0_n, emb_n = y0_rows.to(in_dt), emb_rows.to(in_dt)

        def model_fn(y, t):
            return den(emb_n, y.to(in_dt), y0_n, t).float()

        return model_fn

    @torch.inference_mode()
    def sample_chain(self, y_0_hat, x_emb, generator=None, n_z_samples: Optional[int] = None,
                     noise=None, use_kernel: Optional[bool] = None):
        """The S-member reverse-chain ensemble from y_0_hat [B, L+P, N]:
        samples [B, pred_len, N, S]. ``noise`` (test seam): T arrays
        [S, B, L+P, N], z_T first."""
        S = n_z_samples or self.n_z_samples
        B, L, N = y_0_hat.shape
        y0_rows = y_0_hat[None].expand(S, B, L, N).reshape(S * B, L, N).contiguous()
        emb_rows = x_emb
        if not self.denoiser.cat_y_pred and self.denoiser.cat_x:
            emb_rows = x_emb[None].expand(S, *x_emb.shape).reshape(S * B, *x_emb.shape[1:])
        if noise is not None:
            noise = [torch.as_tensor(z, dtype=torch.float32, device=self.device)
                     .reshape(S * B, L, N) for z in noise]
        samples = D.card_p_sample_loop(
            self.denoiser_fn(y0_rows, emb_rows, use_kernel), y0_rows, self.sched,
            generator=generator if generator is not None else self.generator, noise=noise,
        )
        samples = samples.reshape(S, B, L, N)[:, :, -self.pred_len:, :]
        return samples.permute(1, 2, 3, 0)  # [B, O, N, S]

    @torch.inference_mode()
    def sample_fn(self, batch_x, generator=None, n_z_samples: Optional[int] = None,
                  noise=None):
        """Prediction ensemble for batch_x [B, W, N]: [B, pred_len, N, S]
        (tmdm_adapter.py:116-155)."""
        y_0_hat, x_emb = self.cond_fn(batch_x)
        return self.sample_chain(y_0_hat, x_emb, generator, n_z_samples, noise)

    def evaluation_step(self, batch):
        """(outs [B, O, N, n_z_samples], batch_y or None)."""
        batch_x, batch_y = self.split_batch(batch)
        return self.sample_fn(batch_x, self.generator, self.n_z_samples), batch_y

    # -- training ---------------------------------------------------------
    def loss_fn(self, batch, select: Optional[str] = None, train: bool = True,
                generator: Optional[torch.Generator] = None, t=None, noise=None,
                reparam_eps=None):
        """The training loss on batch [B, windows + pred_len, N]
        (tmdm_adapter.py:90-114) over the label_len + pred_len target.

        ``train`` turns dropout and the VAE's reparameterisation on (else z
        is z_mean); draws come from ``generator`` (default the model's).
        ``t`` [B], ``noise`` [B, label_len + pred_len, N] and ``reparam_eps``
        (the averaged normal of ``NSTransformerVAE``, shaped like z_mean) are
        test seams, drawn when not given. ``select`` is accepted for the
        training loop's sake and ignored."""
        gen = generator if generator is not None else self.generator
        drop = gen if train else None
        batch = self.as_batch(batch)
        batch_x = batch[:, : self.windows, :]
        target_y = batch[:, self.windows : self.windows + self.pred_len, :]
        batch_y = torch.cat([batch_x[:, -self.label_len :, :], target_y], dim=1)
        _, y_0_hat, kl_loss, _ = self.net["cond_pred_model"](
            batch_x, deterministic=not train, generator=gen, reparam_eps=reparam_eps, gen=drop)
        loss_vae_all = log_normal(batch_y, y_0_hat) + self.k_z * kl_loss

        if t is None:
            t = self.antithetic_t(batch.shape[0], self.sched.num_timesteps, gen)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        noise = (torch.randn(batch_y.shape, generator=gen, device=self.device) if noise is None
                 else torch.as_tensor(noise, dtype=torch.float32, device=self.device))
        y_t = D.card_q_sample(batch_y, y_0_hat, self.sched, t, noise)
        emb = self.net["enc_embedding"](batch_x, drop)
        output = self.net["model"](emb, y_t, y_0_hat, t)
        return torch.mean((noise - output) ** 2) + self.k_cond * loss_vae_all

    def trainable_mask(self, select=None):
        return {k: True for k in self.net}

    @torch.no_grad()
    def training_step(self, batch):
        """The loss on batch, dropout and reparameterisation off."""
        return self.loss_fn(batch, train=False)
