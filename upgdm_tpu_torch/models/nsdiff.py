"""NsDiff — non-stationary diffusion with learned mean f(x) and variance g(x).

Counterpart of the sampling surface of ``upgdm_tpu/models/nsdiff.py``:
f(x) (NSTransformer) and g(x) (SigmaEstimation) run once per batch, then an
S-member ensemble of the T-step heteroscedastic reverse chain runs as one
written-out batch of S*B rows (the JAX package's ``vmap``).

Denoiser per step:
  - on the card every step goes through the K1 kernel
    (``ops/kernels/fused_denoiser.py``), whatever ``use_pallas_denoiser``
    says, with matmuls in ``sampling_matmul_dtype`` (default: the
    ``sampling_dtype``, itself bf16 by default) and float32 activations —
    the JAX package's kernel arm; its default flax-in-bf16 arm is XLA code
    with no kernel to port;
  - on the CPU the plain ``NsDiffDenoiser`` runs in ``sampling_dtype``, as
    the JAX package's flax arm does.
The chain state and the posterior arithmetic stay float32 on both.

Training (``loss_fn``, the pretrain stages, ``NsDiffVariants``) is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import diffusion as D
from ..ops.kernels.fused_denoiser import (
    check_dtypes,
    denoiser_gammas,
    denoiser_weights,
    fused_denoiser_rows,
    step_weights,
)
from ..ops.schedules import NsDiffSchedule
from .base import EPS, DiffusionWrapperBase
from .denoise import NsDiffDenoiser
from .ns_transformer import NSTransformer
from .sigma_estimation import SigmaEstimation

__all__ = ["NsDiffModel"]


class NsDiffModel(DiffusionWrapperBase):
    """NsDiff for ``train_model_select`` in {'NsDiff_model', 'pretrain_f',
    'pretrain_g'}; weights are random from ``seed`` until loaded."""

    def __init__(self, net_param: dict, train_model_select: str = "NsDiff_model",
                 seed: int = 0, has_f: bool = True, has_g: bool = True, device=None):
        super().__init__(net_param, seed=seed, device=device)
        p = self.net_param
        self.train_model_select = train_model_select
        self.seq_len = p.setdefault("seq_len", self.windows)
        self.label_len = p.setdefault("label_len", self.windows // 2)
        self.rolling_length = p["rolling_length"]
        self.diffusion_steps = p["diffusion_steps"]
        self.n_z_samples = p.get("n_z_samples", 100)
        has_denoiser = True
        if train_model_select == "pretrain_f":
            has_f, has_g, has_denoiser = True, False, False
        elif train_model_select == "pretrain_g":
            has_f, has_g, has_denoiser = False, True, False
        self.has_f, self.has_g, self.has_denoiser = has_f, has_g, has_denoiser

        self.sched = NsDiffSchedule.create(
            p.get("diffusion_schedule", "linear"),
            self.diffusion_steps,
            p.get("beta_start", 1e-4),
            p.get("beta_end", 2e-2),
        )
        self._sched_dev = D.schedule_on(self.sched, self.device)

        # weights drawn from `seed` without touching the global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if has_f:
                self.net["cond_pred_model"] = NSTransformer(
                    seq_len=self.seq_len,
                    label_len=self.label_len,
                    pred_len=self.pred_len,
                    enc_in=self.dataset_nf,
                    d_model=p.get("d_model", 512),
                    n_heads=p.get("n_heads", 8),
                    e_layers=p.get("e_layers", 2),
                    d_layers=p.get("d_layers", 1),
                    d_ff=p.get("d_ff", 256),
                    activation=p.get("activation", "gelu"),
                    p_hidden_dims=tuple(p.get("p_hidden_dims", (64, 64))),
                    p_hidden_layers=p.get("p_hidden_layers", 2),
                )
                self.init_series_conv(self.net["cond_pred_model"])
            if has_g:
                self.net["cond_pred_model_g"] = SigmaEstimation(
                    self.windows, self.pred_len, self.dataset_nf, 512, self.rolling_length
                )
            if has_denoiser:
                self.net["model"] = NsDiffDenoiser(self.dataset_nf, self.diffusion_steps)
        self.net.to(self.device).eval()

    # ------------------------------------------------------------------
    @property
    def denoiser(self) -> Optional[NsDiffDenoiser]:
        return self.net["model"] if self.has_denoiser else None

    def _apply_f(self, batch_x, dtype=torch.float32):
        if not self.has_f:
            return batch_x.new_zeros(batch_x.shape[0], self.pred_len, self.dataset_nf)
        y0_hat, _ = self._cast("cond_pred_model", dtype)(batch_x.to(dtype))
        return y0_hat.float()

    def _apply_g(self, batch_x, dtype=torch.float32):
        if not self.has_g:
            return batch_x.new_ones(batch_x.shape[0], self.pred_len, self.dataset_nf)
        return self._cast("cond_pred_model_g", dtype)(batch_x.to(dtype)).float()

    @torch.inference_mode()
    def f_and_g(self, batch_x):
        """(y0_hat, gx) [B, pred_len, N] float32; ``fg_sampling_dtype`` casts
        both backbones (default float32)."""
        fg_dt = self.dtype_param("fg_sampling_dtype", "float32")
        batch_x = self.as_batch(batch_x)
        y0_hat = self._apply_f(batch_x, fg_dt)
        gx = self._apply_g(batch_x, fg_dt)
        if self.has_g:
            gx = gx + EPS
        return y0_hat, gx

    @torch.inference_mode()
    def gx_fn(self, batch_x):
        """The cheap closed-form variance pathway (cond_pred_model_g only)."""
        return self._apply_g(self.as_batch(batch_x))

    # ------------------------------------------------------------------
    def denoiser_fn(self, y0_rows, gx_rows, use_kernel: Optional[bool] = None):
        """``model_fn(y, t) -> (eps, sigma)`` for the reverse chain.

        ``use_kernel=None`` means K1 on the card and the plain module on the
        CPU; ``use_kernel=False`` forces the plain module (used to hold the
        kernel path against it on the card).
        """
        d = self.denoiser
        Fdim = y0_rows.shape[-1]
        if use_kernel is None:
            use_kernel = y0_rows.device.type == "cuda"
        if use_kernel:
            self.sampling_dtype()  # validates sampling_dtype
            mm = self.net_param.get(
                "sampling_matmul_dtype", self.net_param.get("sampling_dtype", "bfloat16"))
            act = self.net_param.get("sampling_act_dtype", "float32")
            kw = denoiser_weights(d)
            if y0_rows.is_cuda:  # laid out once for the chain's launches
                kw = step_weights(kw, check_dtypes(mm, act))
            # x = [y_t, y0_hat, gx] rows; the y0_hat/gx columns are written once
            x = torch.empty(y0_rows.numel() // Fdim, 3 * Fdim, device=y0_rows.device)
            x[:, Fdim:2 * Fdim] = y0_rows.reshape(-1, Fdim)
            x[:, 2 * Fdim:] = gx_rows.reshape(-1, Fdim)

            def model_fn(y, t):
                x[:, :Fdim] = y.reshape(-1, Fdim)
                eps, sig = fused_denoiser_rows(x, denoiser_gammas(d, t), kw,
                                               matmul_dtype=mm, act_dtype=act)
                return eps.reshape(y.shape), sig.reshape(y.shape)

            return model_fn

        in_dt = self.sampling_dtype()
        den = self._cast("model", in_dt)
        y0_n, gx_n = y0_rows.to(in_dt), gx_rows.to(in_dt)

        def model_fn(y, t):
            eps, sig = den(y.to(in_dt), y0_n, gx_n, t)
            return eps.float(), sig.float()

        return model_fn

    @torch.inference_mode()
    def sample_chain(self, y0_hat, gx, generator=None, n_z_samples: Optional[int] = None,
                     use_gx_directly: bool = False, noise=None,
                     use_kernel: Optional[bool] = None):
        """The S-member reverse-chain ensemble from (y0_hat, gx) [B, O, N]:
        samples [B, O, N, S]. ``noise`` (test seam): T arrays [S, B, O, N],
        z_T first."""
        S = n_z_samples or self.n_z_samples
        B, O, N = y0_hat.shape
        y0_rows = y0_hat[None].expand(S, B, O, N).reshape(S * B, O, N).contiguous()
        gx_rows = gx[None].expand(S, B, O, N).reshape(S * B, O, N).contiguous()
        if noise is not None:
            noise = [torch.as_tensor(z, dtype=torch.float32, device=self.device)
                     .reshape(S * B, O, N) for z in noise]
        samples = D.nsdiff_p_sample_loop(
            self.denoiser_fn(y0_rows, gx_rows, use_kernel), y0_rows, gx_rows,
            self._sched_dev, generator=generator if generator is not None else self.generator,
            use_gx_directly=use_gx_directly, noise=noise,
        )
        return samples.reshape(S, B, O, N).permute(1, 2, 3, 0)  # [B, O, N, S]

    @torch.inference_mode()
    def sample_fn(self, batch_x, generator=None, n_z_samples: Optional[int] = None,
                  use_gx_directly: bool = False, noise=None):
        """Prediction ensemble for batch_x [B, W, N]: [B, pred_len, N, S]."""
        y0_hat, gx = self.f_and_g(batch_x)
        return self.sample_chain(y0_hat, gx, generator, n_z_samples, use_gx_directly, noise)

    def evaluation_step(self, batch, use_gx_directly: bool = False):
        """(outs [B, O, N, n_z_samples], batch_y or None) — NsDiff_model.py:180-268."""
        batch_x, batch_y = self.split_batch(batch)
        outs = self.sample_fn(batch_x, self.generator, self.n_z_samples, use_gx_directly)
        return outs, batch_y
