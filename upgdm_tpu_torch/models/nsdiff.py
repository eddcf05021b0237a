"""NsDiff — non-stationary diffusion with learned mean f(x) and variance g(x).

Counterpart of ``upgdm_tpu/models/nsdiff.py``. Sampling: f(x)
(NSTransformer) and g(x) (SigmaEstimation) run once per batch, then an
S-member ensemble of the T-step heteroscedastic reverse chain runs as one
written-out batch of S*B rows (the JAX package's ``vmap``).

Denoiser per step:
  - on the card every step goes through the K1 kernel
    (``ops/kernels/fused_denoiser.py``), whatever ``use_pallas_denoiser``
    says, with matmuls in ``sampling_matmul_dtype`` (default: the
    ``sampling_dtype``, itself bf16 by default) and activations in
    ``sampling_act_dtype`` (default float32; bf16 needs bf16 matmuls) — the
    JAX package's kernel arm; its default flax-in-bf16 arm is XLA code with
    no kernel to port;
  - on the CPU the plain ``NsDiffDenoiser`` runs in ``sampling_dtype``, as
    the JAX package's flax arm does.
The chain state and the posterior arithmetic stay float32 on both.

Training: the three-stage protocol (pretrain_f -> pretrain_g -> NsDiff_model
with ``load_pretrain``) is ``loss_fn(..., select)`` plus ``trainable_mask``,
which ``train/loop.py::run_training`` turns into frozen and optimised
modules; ``NsDiffVariants`` are the ablations. The loss runs the plain
modules with autograd on both devices (the JAX package has no backward
kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import diffusion as D
from ..ops.rolling import wv_sigma_trailing
from ..ops.kernels.fused_denoiser import (
    check_dtypes,
    denoiser_gammas,
    denoiser_weights,
    fused_denoiser_rows,
    step_weights,
)
from ..ops.schedules import NsDiffSchedule
from ..parallel import draws
from ..utils.io import load_checkpoint
from ..utils.profiling import annotate
from ..utils.weights import torch_state_from_flax
from .base import EPS, DiffusionWrapperBase
from .denoise import NsDiffDenoiser
from .ns_transformer import NSTransformer
from .sigma_estimation import SigmaEstimation

__all__ = ["NsDiffModel", "NsDiffVariants"]


class NsDiffModel(DiffusionWrapperBase):
    """NsDiff for ``train_model_select`` in {'NsDiff_model', 'pretrain_f',
    'pretrain_g'}; weights are random from ``seed`` until loaded.

    A pretrain stage holds only its own module (its checkpoint is that
    subtree). The NsDiff_model stage with ``load_pretrain`` takes g(x) from
    ``pretrain_g_path`` and, with ``load_pretrain_f`` too, f(x) from
    ``pretrain_f_path`` (directories holding ``model_trained``)."""

    def __init__(self, net_param: dict, train_model_select: str = "NsDiff_model",
                 pretrain_f_path: Optional[str] = None, pretrain_g_path: Optional[str] = None,
                 seed: int = 0, has_f: bool = True, has_g: bool = True,
                 wo_uans: bool = False, device=None):
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
        self.wo_uans = wo_uans

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
            self._build_modules()
        self.net.to(self.device).eval()

        if train_model_select == "NsDiff_model" and p.get("load_pretrain"):
            if pretrain_g_path:
                self._load_pretrain("cond_pred_model_g", pretrain_g_path)
            if pretrain_f_path and p.get("load_pretrain_f"):
                self._load_pretrain("cond_pred_model", pretrain_f_path)

    def _build_modules(self) -> None:
        """The stage's modules into ``self.net``, drawn from the global
        stream (seeded by ``__init__``) with flax's initialisers."""
        p = self.net_param
        if self.has_f:
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
                dropout=p.get("dropout", 0.05),
                activation=p.get("activation", "gelu"),
                p_hidden_dims=tuple(p.get("p_hidden_dims", (64, 64))),
                p_hidden_layers=p.get("p_hidden_layers", 2),
            )
        if self.has_g:
            self.net["cond_pred_model_g"] = SigmaEstimation(
                self.windows, self.pred_len, self.dataset_nf, 512, self.rolling_length
            )
        if self.has_denoiser:
            self.net["model"] = NsDiffDenoiser(self.dataset_nf, self.diffusion_steps)
        self.init_like_flax(self.net)

    def _load_pretrain(self, name: str, path) -> None:
        """net[name] from the ``name.`` subtree of ``<path>/model_trained``
        (a pretrain stage's or any full checkpoint; other keys are left)."""
        _, sd = load_checkpoint(str(path) + "/model_trained")
        prefix = name + "."
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        self.net[name].load_state_dict(torch_state_from_flax(sub), strict=True)
        self.weights_changed()

    # ------------------------------------------------------------------
    @property
    def denoiser(self) -> Optional[NsDiffDenoiser]:
        return self.net["model"] if self.has_denoiser else None

    def _apply_f(self, batch_x, dtype=None, gen=None):
        """f(x) (``gen`` turns dropout on): with ``dtype`` the input and a cast
        copy of the module in that type, else as they are; the output in the
        type the module's promotions give (zeros of the input's type without
        f)."""
        if not self.has_f:
            return batch_x.new_zeros(batch_x.shape[0], self.pred_len, self.dataset_nf)
        if dtype is None:
            return self.net["cond_pred_model"](batch_x, gen)[0]
        return self._cast("cond_pred_model", dtype)(batch_x.to(dtype), gen)[0]

    def _apply_g(self, batch_x, dtype=None):
        if not self.has_g:
            return batch_x.new_ones(batch_x.shape[0], self.pred_len, self.dataset_nf)
        if dtype is None:
            return self.net["cond_pred_model_g"](batch_x)
        return self._cast("cond_pred_model_g", dtype)(batch_x.to(dtype))

    @annotate("upgdm.backbone")
    @torch.inference_mode()
    def f_and_g(self, batch_x):
        """(y0_hat, gx) [B, pred_len, N] float32; ``fg_sampling_dtype`` casts
        both backbones (default float32)."""
        fg_dt = self.dtype_param("fg_sampling_dtype", "float32")
        batch_x = self.as_batch(batch_x)
        y0_hat = self._apply_f(batch_x, fg_dt).float()
        gx = self._apply_g(batch_x, fg_dt).float()
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

    @annotate("upgdm.chain")
    @torch.inference_mode()
    def sample_chain(self, y0_hat, gx, generator=None, n_z_samples: Optional[int] = None,
                     use_gx_directly: bool = False, noise=None,
                     use_kernel: Optional[bool] = None):
        """The S-member reverse-chain ensemble from (y0_hat, gx) [B, O, N]:
        samples [B, O, N, S]. ``noise`` (test seam): T arrays [S, B, O, N],
        z_T first; under a row shard the global batch's, cut to the rank's
        rows."""
        S = n_z_samples or self.n_z_samples
        B, O, N = y0_hat.shape
        y0_rows = y0_hat[None].expand(S, B, O, N).reshape(S * B, O, N).contiguous()
        gx_rows = gx[None].expand(S, B, O, N).reshape(S * B, O, N).contiguous()
        if noise is not None:
            noise = [draws.keep_rows(torch.as_tensor(z, dtype=torch.float32, device=self.device)
                                     .reshape(S, -1, O, N), 1).reshape(S * B, O, N)
                     for z in noise]
        samples = D.nsdiff_p_sample_loop(
            self.denoiser_fn(y0_rows, gx_rows, use_kernel), y0_rows, gx_rows,
            self.sched, generator=generator if generator is not None else self.generator,
            use_gx_directly=use_gx_directly, noise=noise, members=S,
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

    # -- training ---------------------------------------------------------
    def loss_fn(self, batch, select: Optional[str] = None, train: bool = True,
                generator: Optional[torch.Generator] = None, t=None, noise=None):
        """Single-step loss of any stage for batch [B, windows + pred_len, N]
        (NsDiff_model.py:111-179; variants :336-402): pretrain_f MSE,
        pretrain_g MSE of the square roots against the trailing variance,
        else the KL step plus the f and g terms of the modules it has. A
        bf16 batch (``cast_loss``) keeps its type, as do the draws.

        ``train`` turns dropout on; draws come from ``generator`` (default
        the model's). ``t`` [B] and ``noise`` [B, pred_len, N] (the standard
        normal before its scaling) are test seams, drawn when not given."""
        select = select or self.train_model_select
        gen = generator if generator is not None else self.generator
        drop = gen if train else None
        batch = self.as_batch(batch)
        batch_x = batch[:, : self.windows, :]
        batch_y = batch[:, self.windows : self.windows + self.pred_len, :]
        if select == "pretrain_f":
            return torch.mean((self._apply_f(batch_x, gen=drop) - batch_y) ** 2)
        y_sigma = wv_sigma_trailing(
            torch.cat([batch_x, batch_y], dim=1), self.rolling_length
        )[:, -self.pred_len :, :] + EPS
        if select == "pretrain_g":
            return torch.mean((torch.sqrt(self._apply_g(batch_x)) - torch.sqrt(y_sigma)) ** 2)

        sched = self._sched_dev
        if t is None:
            t = self.antithetic_t(batch.shape[0], sched.num_timesteps, gen)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        y0_hat = self._apply_f(batch_x, gen=drop)
        gx = self._apply_g(batch_x) + EPS
        loss1 = torch.mean((y0_hat - batch_y) ** 2) if self.has_f else 0.0
        loss2 = torch.mean((torch.sqrt(gx) - torch.sqrt(y_sigma)) ** 2) if self.has_g else 0.0
        e = (draws.randn(batch_y.shape, gen, device=self.device, dtype=batch_y.dtype)
             if noise is None else torch.as_tensor(noise, dtype=batch_y.dtype, device=self.device))
        c = D.nsdiff_gather(sched, t, batch_y)
        y_t = D.nsdiff_q_sample(batch_y, y0_hat, sched, t,
                                e * torch.sqrt(D.nsdiff_forward_noise(c, gx, y_sigma)))
        output, sigma_theta = self.net["model"](y_t, y0_hat, gx, t)
        kl = torch.mean((e - output) ** 2)
        if not self.wo_uans:
            ratio = D.nsdiff_sigma_tilde(c, gx, y_sigma) / (sigma_theta + EPS)
            kl = kl + torch.mean(ratio) - torch.mean(torch.log(ratio))
        return kl + loss1 + loss2

    def trainable_mask(self, select: Optional[str] = None):
        """The stage's own module in a pretrain stage; only the denoiser with
        ``freeze_pretrain``; else everything (NsDiff_model.py:86-93)."""
        select = select or self.train_model_select
        freeze = self.net_param.get("freeze_pretrain", False)
        if select == "pretrain_f":
            return {k: k == "cond_pred_model" for k in self.net}
        if select == "pretrain_g":
            return {k: k == "cond_pred_model_g" for k in self.net}
        return {k: (k == "model") if freeze else True for k in self.net}

    @torch.no_grad()
    def training_step(self, batch):
        """The stage's loss on batch, dropout off (reference surface)."""
        return self.loss_fn(batch, train=False)

    @torch.no_grad()
    def pretrain_f(self, batch):
        return self.loss_fn(batch, "pretrain_f", train=False)

    @torch.no_grad()
    def pretrain_g(self, batch):
        return self.loss_fn(batch, "pretrain_g", train=False)

    def convert_reference_state_dict(self, flat, strict: bool = True):
        """A reference torch checkpoint as the flax-named flat dict
        (``utils/torch_import.py``); a native dict passes unchanged. Only the
        subtrees this stage holds are expected."""
        from ..utils.torch_import import (
            convert_reference_nsdiff_state_dict,
            looks_like_reference_nsdiff_state_dict,
        )

        if not looks_like_reference_nsdiff_state_dict(flat):
            return flat
        components = tuple(k for k in ("model", "cond_pred_model", "cond_pred_model_g")
                           if k in self.net)
        return convert_reference_nsdiff_state_dict(
            flat, self.net_param, strict=strict, components=components)


class NsDiffVariants(NsDiffModel):
    """Ablation variants (NsDiff_model.py:271-495): ``train_model_select`` in
    {'Guassian', 'cond_mean', 'cond_var', 'wo_UANS'}; every module trains."""

    _VARIANTS = {
        "Guassian": dict(has_f=False, has_g=False, wo_uans=False),
        "cond_mean": dict(has_f=True, has_g=False, wo_uans=False),
        "cond_var": dict(has_f=False, has_g=True, wo_uans=False),
        "wo_UANS": dict(has_f=True, has_g=True, wo_uans=True),
    }

    def __init__(self, net_param: dict, train_model_select: str, seed: int = 0, device=None):
        if train_model_select not in self._VARIANTS:
            raise ValueError(
                "train_model_select should be in Guassian/cond_mean/cond_var/wo_UANS")
        super().__init__(net_param, train_model_select="NsDiff_model", seed=seed, device=device,
                         **self._VARIANTS[train_model_select])
        self.variant = train_model_select

    def trainable_mask(self, select=None):
        return {k: True for k in self.net}
