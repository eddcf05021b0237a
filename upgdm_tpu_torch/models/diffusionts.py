"""DiffusionTS — x0-prediction diffusion with DDIM infill and a Langevin
corrector.

Counterpart of ``upgdm_tpu/models/diffusionts.py`` (reference
DiffusionTS_model.py:9-109, DiffusionTS.py:35-407). The denoiser is
``DTSTransformer``; the model predicts x0 and trains on the x0 error plus a
Fourier term, weighted by the schedule's ``loss_weight[t]``.

Sampling fills in the future of [history, zeros] with the history known: a
DDIM walk over the static (time, time_next) pairs, each step followed by
K in {0, 1, 2, 3} Langevin steps (by time, DiffusionTS.py:372-381) that take
gradients of an infill loss through the transformer with respect to the
chain state, and by the known region reset to its forward-noised target.
Each Langevin step is a fresh Adagrad step, z - lr g / (sqrt(g^2) + 1e-10)
(the reference builds a new optimizer every inner iteration). The S
ensemble members of a call run as one batch of S*B rows (the JAX package's
``vmap``), in chunks of ``sample_chunk`` members (default
``parallel_sample``); ``evaluation_step`` draws the ensemble in rounds of
``parallel_sample``.

The sampler is not under ``torch.inference_mode``: the corrector saves
tensors for backward. The forwards outside it run under ``no_grad`` and the
corrector under ``enable_grad``, with ``torch.autograd.grad`` with respect to
the chain state alone. In bf16 sampling (``sampling_dtype``, default bf16)
the transformer is a cast copy of the weights; the chain state, the
posterior coefficients and the corrector's update stay float32 and the
gradient comes back float32.

Draws come from an explicit ``torch.Generator`` (the model's by default);
``loss_fn`` (``t``, ``noise``) and the samplers (``noise``) take the draws
as optional arguments: test seams through which a test hands the port the
draws JAX took from its keys.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import diffusion as D
from ..ops.schedules import ddim_time_pairs, diffusionts_schedule
from ..parallel import draws
from .base import DiffusionWrapperBase, flax_truncated_normal_
from .diffusionts_net import DTSTransformer, TimeMixDense
from .ugnet import init_like_flax

__all__ = ["DiffusionTSModel"]


class DiffusionTSModel(DiffusionWrapperBase):
    """DiffusionTS over a ``DTSTransformer``; weights are random from
    ``seed`` until loaded."""

    def __init__(self, net_param: dict, seed: int = 0, device=None, **_):
        super().__init__(net_param, seed=seed, device=device)
        p = self.net_param
        self.seq_len = p.setdefault("seq_len", self.windows)
        self.label_len = p.setdefault("label_len", self.windows // 2)
        self.seq_length = self.windows + self.pred_len
        self.n_z_samples = p.get("n_z_samples", 100)
        self.parallel_sample = p.get("parallel_sample", min(10, self.n_z_samples))
        self.sampling_timesteps = p.get("diffusion_steps", 100)
        self.timesteps = p.get("timesteps", 100)
        self.loss_type = p.get("loss_type", "l2")
        self.eta = p.get("eta", 0.0)
        self.use_ff = p.get("use_ff", True)
        self.ff_weight = p.get("reg_weight") or math.sqrt(self.seq_length) / 5
        self.infill_coef = p.get("infill_coef", 1e-1)
        self.infill_lr = p.get("infill_learning_rate", 5e-2)
        # window-rows per sampling call (eval.uncertainty.bounded_chunk_windows)
        # and the cache runner's flush interval: the JAX package's values
        self.eval_rows_per_call = p.get("eval_rows_per_call", 32)
        self.eval_checkpoint_every = p.get("eval_checkpoint_every", 4)

        self.sched = diffusionts_schedule(p.get("beta_schedule", "cosine"), self.timesteps)
        self._sched_dev = D.schedule_on(self.sched, self.device)
        # weights drawn from `seed` without touching the global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net["model"] = DTSTransformer(
                n_feat=self.dataset_nf,
                n_channel=self.seq_length,
                n_layer_enc=p.get("n_layer_enc", 3),
                n_layer_dec=p.get("n_layer_dec", 6),
                n_embd=p.get("d_model", 64),
                n_heads=p.get("n_heads", 4),
                attn_pdrop=p.get("attn_pd", 0.0),
                resid_pdrop=p.get("resid_pd", 0.0),
                mlp_hidden_times=p.get("mlp_hidden_times", 4),
                conv_kernel=p.get("kernel_size"),
            )
            # flax's initialisers: Dense and Conv kernels lecun-normal; the
            # time-mixing kernels' fan-in is their flax shape's T_out
            init_like_flax(self.net)
            for m in self.net.modules():
                if isinstance(m, TimeMixDense):
                    flax_truncated_normal_(m.weight, m.weight.shape[1], 1.0)
        self.net.to(self.device).eval()
        # history known, future unknown (DiffusionTS_model.py:47-54)
        self.gt_mask = np.concatenate([np.ones((self.windows, self.dataset_nf), bool),
                                       np.zeros((self.pred_len, self.dataset_nf), bool)])

    # ------------------------------------------------------------------
    @staticmethod
    def _output(net, x, t, gen=None):
        """trend + season of ``net`` as float32; x is cast to the net's type
        (a bf16 copy in bf16 sampling, bf16 weights under ``cast_loss``), so
        a gradient with respect to a float32 x comes back float32."""
        trend, season = net(x.to(net.emb.Conv_0.weight.dtype), t, gen=gen)
        return (trend + season).float()

    def _elem_loss(self, a, b):
        if self.loss_type == "l1":
            return torch.abs(a - b)
        return (a - b) ** 2

    def loss_fn(self, batch, select: Optional[str] = None, train: bool = True,
                generator: Optional[torch.Generator] = None, t=None, noise=None):
        """The training loss with target x0 (DiffusionTS.py:239-266) of batch
        [B, windows + pred_len, N]: the x0 error plus ``ff_weight`` times the
        error of the real and imaginary parts of the forward-normalised FFT
        over time, averaged per sample, weighted by ``loss_weight[t]``.
        ``train`` turns dropout on; draws come from ``generator`` (default
        the model's). ``t`` [B] in 0..T-1 and ``noise`` (shaped like the
        window) are test seams. ``select`` is accepted for the training
        loop's sake and ignored."""
        gen = generator if generator is not None else self.generator
        batch = self.as_batch(batch)
        data = batch[:, : self.seq_length, :]
        B = data.shape[0]
        if t is None:
            t = draws.randint(0, self.timesteps, (B,), gen, device=self.device)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        noise = (draws.randn(data.shape, gen, dtype=data.dtype, device=self.device)
                 if noise is None else torch.as_tensor(noise, dtype=data.dtype,
                                                       device=self.device))
        x = D.dts_q_sample(data, self._sched_dev, t, noise)
        model_out = self._output(self.net["model"], x, t, gen if train else None)
        train_loss = self._elem_loss(model_out, data)
        if self.use_ff:
            fft1 = torch.fft.fft(model_out, dim=1, norm="forward")
            fft2 = torch.fft.fft(data.float(), dim=1, norm="forward")
            train_loss = train_loss + self.ff_weight * (
                self._elem_loss(fft1.real, fft2.real) + self._elem_loss(fft1.imag, fft2.imag))
        per_sample = train_loss.reshape(B, -1).mean(dim=1)
        return torch.mean(per_sample * self._sched_dev.loss_weight[t])

    # -- sampling ---------------------------------------------------------
    def ddim_step_table(self):
        """(pairs, rows): the DDIM (time, time_next) pairs and, for each but
        the last (whose time_next < 0 gives img = x_start), the step's
        (time, sigma, c, sqrt(alpha_next), K, lr), from the float64 schedule
        rounded to float32 as the JAX package's tables. K and lr are the
        Langevin schedule (DiffusionTS.py:372-381)."""
        pairs = ddim_time_pairs(self.timesteps, self.sampling_timesteps)
        acp = self.sched.alphas_cumprod.astype(np.float64)
        T = self.timesteps
        f32 = lambda v: float(np.float32(v))
        rows = []
        for time, time_next in pairs[:-1]:
            alpha, alpha_next = float(acp[time]), float(acp[time_next])
            sigma = self.eta * ((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)) ** 0.5
            c = (1 - alpha_next - sigma ** 2) ** 0.5
            if time < T * 0.05:
                K, lr = 0, 0.0
            elif time > T * 0.9:
                K, lr = 3, self.infill_lr
            elif time > T * 0.75:
                K, lr = 2, self.infill_lr * 0.5
            else:
                K, lr = 1, self.infill_lr * 0.25
            rows.append((time, f32(sigma), f32(c), f32(alpha_next ** 0.5), K, f32(lr)))
        return pairs, rows

    def _sampling_net(self):
        return self._cast("model", self.sampling_dtype())

    def _x_start(self, net, img, t_b):
        return torch.clamp(self._output(net, img, t_b), -1.0, 1.0)

    def _langevin(self, net, sample, mean, sigma, t_b, lr, K, target, mask, rows_per_sample):
        """K fresh-Adagrad steps on the infill loss of each sample, the known
        region kept (DiffusionTS.py:383-407). The loss of a member is a mean
        over its ``rows_per_sample`` rows, so the one loss over all rows is
        their sum divided by that count, and its gradient is every member's."""
        if K == 0 or lr == 0.0:
            return sample
        div = sigma if sigma != 0.0 else 1.0
        z = sample
        for _ in range(K):
            with torch.enable_grad():
                z = z.detach().requires_grad_()
                diff = torch.where(mask, self._output(net, z, t_b) - target, 0.0) ** 2
                loss = (self.infill_coef * ((mean - z) ** 2).sum() + diff.sum()) / (
                    div * rows_per_sample)
                (g,) = torch.autograd.grad(loss, z)
            z = z.detach() - lr * g / (torch.sqrt(g * g) + 1e-10)
        return torch.where(mask, sample, z)

    @torch.no_grad()
    def fast_sample_infill_fn(self, target, partial_mask, rows_per_sample: Optional[int] = None,
                              generator=None, noise=None):
        """Conditional DDIM infill (DiffusionTS.py:277-310) of rows [N, T, F]:
        ``target`` with the unknown region zeroed, ``partial_mask`` bool True
        where known; the rows are ensemble members of ``rows_per_sample`` rows
        each (default all N: one member). ``noise`` (test seam): (img [N, T,
        F], kn [steps, N, T, F], kq [steps, N, T, F]), the initial state, the
        DDIM noise (times sigma) and the target's forward noise of each step."""
        gen = generator if generator is not None else self.generator
        target = torch.as_tensor(target, dtype=torch.float32, device=self.device)
        mask = torch.as_tensor(partial_mask, dtype=torch.bool, device=self.device)
        N = target.shape[0]
        B = rows_per_sample or N
        net = self._sampling_net()
        sched = self._sched_dev
        pairs, rows = self.ddim_step_table()

        members = N // B
        shape = (members, B) + tuple(target.shape[1:])

        def draw(z):  # the rows are members sample-major copies of the batch
            if z is not None:
                return torch.as_tensor(z, dtype=torch.float32, device=self.device)
            return draws.randn(shape, gen, device=self.device, batch_axis=1).reshape(target.shape)

        img0, kns, kqs = noise if noise is not None else (None, [None] * len(rows),
                                                         [None] * len(rows))
        img = draw(img0)
        for (time, sigma, c, sqrt_an, K, lr), kn, kq in zip(rows, kns, kqs):
            t_b = torch.full((N,), time, dtype=torch.long, device=self.device)
            x_start = self._x_start(net, img, t_b)
            pred_noise = D.dts_predict_noise_from_start(img, sched, t_b, x_start)
            pred_mean = x_start * sqrt_an + c * pred_noise
            img = pred_mean + sigma * draw(kn) if sigma != 0.0 else pred_mean
            img = self._langevin(net, img, pred_mean, sigma, t_b, lr, K, target, mask, B)
            img = torch.where(mask, D.dts_q_sample(target, sched, t_b, draw(kq)), img)
        # the last pair: time_next < 0 gives img = x_start (DiffusionTS.py:291-293)
        t_last = torch.full((N,), pairs[-1][0], dtype=torch.long, device=self.device)
        return torch.where(mask, target, self._x_start(net, img, t_last))

    def sample_fn(self, batch_x, generator=None, n_z_samples: Optional[int] = None, noise=None):
        """Ensemble of infilled futures for batch_x [B, W, N]: [B, pred_len,
        N, S]. ``noise`` (test seam): (img [S, B, T, N], kn [steps, S, B, T,
        N], kq [steps, S, B, T, N])."""
        S = n_z_samples or self.n_z_samples
        batch_x = self.as_batch(batch_x)
        B = batch_x.shape[0]
        x = torch.cat([batch_x, batch_x.new_zeros(B, self.pred_len, self.dataset_nf)], dim=1)
        mask = torch.as_tensor(self.gt_mask, device=self.device).expand(x.shape)
        target = x * mask
        chunk = self.net_param.get("sample_chunk", self.parallel_sample) or S
        rows = lambda a, n: a[None].expand(n, *a.shape).reshape(n * B, *a.shape[1:])
        out = []
        for s0 in range(0, S, chunk):
            n = min(chunk, S - s0)
            part = None
            if noise is not None:
                img, kn, kq = (torch.as_tensor(np.asarray(a), dtype=torch.float32)
                               for a in noise)
                flat = lambda a: a.reshape(a.shape[0], n * B, *a.shape[3:])
                part = (img[s0 : s0 + n].reshape(n * B, *img.shape[2:]),
                        flat(kn[:, s0 : s0 + n]), flat(kq[:, s0 : s0 + n]))
            out.append(self.fast_sample_infill_fn(rows(target, n), rows(mask, n), B, generator,
                                                  part).reshape(n, B, *x.shape[1:]))
        samples = torch.cat(out)[:, :, -self.pred_len :, :]  # [S, B, P, N]
        return samples.permute(1, 2, 3, 0)

    def evaluation_step(self, batch):
        """(outs [B, pred_len, N, n_z_samples], batch_y or None): the ensemble
        in rounds of ``parallel_sample`` draws, the reference's sampling-loop
        shape."""
        batch_x, batch_y = self.split_batch(batch)
        S, R = self.n_z_samples, self.parallel_sample
        if R and R < S:
            rounds = [self.sample_fn(batch_x, self.generator, R) for _ in range(-(-S // R))]
            return torch.cat(rounds, dim=-1)[..., :S], batch_y
        return self.sample_fn(batch_x, self.generator, S), batch_y

    @torch.no_grad()
    def generate_mts_fn(self, generator=None, batch_size: int = 16, noise=None):
        """Unconditional DDIM generation (DiffusionTS.py:178-221): [batch_size,
        windows + pred_len, N]. ``noise`` (test seam): (img, z [steps, ...])."""
        gen = generator if generator is not None else self.generator
        shape = (batch_size, self.seq_length, self.dataset_nf)
        net = self._sampling_net()
        pairs, rows = self.ddim_step_table()

        def draw(z):
            if z is not None:
                return torch.as_tensor(z, dtype=torch.float32, device=self.device)
            return torch.randn(shape, generator=gen, device=self.device)

        img0, zs = noise if noise is not None else (None, [None] * len(rows))
        img = draw(img0)
        for (time, sigma, c, sqrt_an, _, _), z in zip(rows, zs):
            t_b = torch.full((batch_size,), time, dtype=torch.long, device=self.device)
            x_start = self._x_start(net, img, t_b)
            pred_noise = D.dts_predict_noise_from_start(img, self._sched_dev, t_b, x_start)
            img = x_start * sqrt_an + c * pred_noise
            if sigma != 0.0:
                img = img + sigma * draw(z)
        t_last = torch.full((batch_size,), pairs[-1][0], dtype=torch.long, device=self.device)
        return self._x_start(net, img, t_last)

    def trainable_mask(self, select=None):
        return {k: True for k in self.net}

    def convert_reference_state_dict(self, flat, strict: bool = True):
        """A reference torch checkpoint (the Transformer under
        ``model.model.*``) as the flax-named flat dict
        (``utils/torch_import.py``); a native dict passes unchanged."""
        if not any(k.startswith("model.model.") for k in flat):
            return flat
        from ..utils.torch_import import convert_reference_dts_state_dict

        return convert_reference_dts_state_dict(flat, self.net_param, strict=strict)

    @torch.no_grad()
    def training_step(self, batch):
        """The loss on batch, dropout off (reference surface)."""
        return self.loss_fn(batch, train=False)
