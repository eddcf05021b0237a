"""Shared wrapper plumbing of the port's diffusion models.

Counterpart of ``upgdm_tpu/models/base.py``. A wrapper holds its torch
modules in one ``nn.ModuleDict`` (``self.net``) whose top-level names are the
JAX package's param-tree roots (``cond_pred_model``, ``cond_pred_model_g``,
``enc_embedding``, ``model``), and keeps the reference's stateful surface:
scalers, ``state_dict``/``load_state_dict`` over the flax-named flat dict,
the sampling dtype knobs and the training contract (``trainable_mask`` by
top-level name, ``antithetic_t``, ``weights_changed``).

RNG: an explicit ``torch.Generator`` on the model's device, seeded from
``seed``, replaces the JAX package's fold-in key counter. Fresh weights are
drawn from ``seed`` with flax's initialisers (``init_like_flax``), so a run
from scratch starts from the JAX package's distributions.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.scalers import StandardScaler
from ..utils.weights import SCALER_KEYS, flax_flat_from_torch, torch_state_from_flax

EPS = 10e-8  # 1e-7, the reference's epsilon

__all__ = ["EPS", "DiffusionWrapperBase"]


class DiffusionWrapperBase:
    scaler_axis = 0  # flat series

    _SAMPLING_DTYPES = {
        "float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    }

    def __init__(self, net_param: dict, seed: int = 0, device=None):
        self.device = resolve_device(device)
        # float32 means float32 on the card too: matmuls and the cuDNN
        # convolutions of DataEmbedding/Projector would otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.net_param = dict(net_param)
        self.dataset_nf = net_param["dataset_nf"]
        self.windows = net_param["windows"]
        self.pred_len = net_param["pred_len"]
        self.scaler = net_param.get("scaler_type")
        if self.scaler in (None, "None"):
            self.scaler = None
        self._scaler = StandardScaler(
            mean=np.zeros(self.dataset_nf, np.float32),
            std=np.ones(self.dataset_nf, np.float32),
        )
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.net = nn.ModuleDict()
        self._cast_cache = {}

    # -- scaler (reference semantics: NsDiff_model.py:99-110) --------------
    def scaler_fit(self, data):
        self._scaler.fit(np.asarray(data), axis=self.scaler_axis)

    def scaler_transform(self, data):
        return self._scaler.transform(data)

    def scaler_inverse_transform(self, data):
        return self._scaler.inverse_transform(data)

    @property
    def scaler_mean(self):
        return self._scaler.mean

    @property
    def scaler_std(self):
        return self._scaler.std

    # -- checkpoint surface: the flax-named flat dict -----------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        flat = flax_flat_from_torch(self.net.state_dict())
        flat["scaler_mean"] = np.asarray(self._scaler.mean, np.float32)
        flat["scaler_std"] = np.asarray(self._scaler.std, np.float32)
        return flat

    def load_state_dict(self, flat: Dict[str, np.ndarray], strict: bool = True):
        flat = dict(flat)
        if "scaler_mean" in flat:
            self._scaler.mean = np.asarray(flat["scaler_mean"], np.float32)
        if "scaler_std" in flat:
            self._scaler.std = np.asarray(flat["scaler_std"], np.float32)
        for k in SCALER_KEYS:
            flat.pop(k, None)
        self.net.load_state_dict(torch_state_from_flax(flat), strict=strict)
        self.weights_changed()

    def weights_changed(self) -> None:
        """Drop the cast copies of ``_cast``: call after the weights of
        ``self.net`` change in place (an optimizer step, a load)."""
        self._cast_cache = {}

    def _cast(self, name: str, dtype: torch.dtype) -> nn.Module:
        """net[name], or a cached copy of it cast to ``dtype`` (valid until
        ``weights_changed``)."""
        if dtype == torch.float32:
            return self.net[name]
        key = (name, dtype)
        if key not in self._cast_cache:
            self._cast_cache[key] = copy.deepcopy(self.net[name]).to(dtype)
        return self._cast_cache[key]

    # -- helpers ------------------------------------------------------------
    def dtype_param(self, name: str, default: str) -> torch.dtype:
        """Validated net_param[name] -> torch dtype (a typo raises)."""
        s = str(self.net_param.get(name, default))
        try:
            return self._SAMPLING_DTYPES[s]
        except KeyError:
            raise ValueError(
                f"{name}={s!r}: expected one of {sorted(self._SAMPLING_DTYPES)}"
            ) from None

    def sampling_dtype(self, default: str = "bfloat16") -> torch.dtype:
        return self.dtype_param("sampling_dtype", default)

    def as_batch(self, batch) -> torch.Tensor:
        """A batch (numpy or tensor) as float32 on the model's device."""
        return torch.as_tensor(batch, dtype=torch.float32, device=self.device)

    def split_batch(self, batch):
        """(batch_x [B, W, N], batch_y [B, pred_len, N] or None) of a batch
        that holds the history and, where it is long enough, the target."""
        batch = self.as_batch(batch)
        batch_x = batch[:, : self.windows, :]
        batch_y = (
            batch[:, self.windows : self.windows + self.pred_len, :]
            if batch.shape[1] - self.windows >= self.pred_len
            else None
        )
        return batch_x, batch_y

    # -- training contract --------------------------------------------------
    def trainable_mask(self, select: Optional[str] = None) -> Dict[str, bool]:
        """{top-level name of ``self.net``: trained or frozen}."""
        raise NotImplementedError

    def antithetic_t(self, n: int, num_timesteps: int, generator=None) -> torch.Tensor:
        """Antithetic timesteps (NsDiff_model.py:149-152): n // 2 + 1 draws
        from [0, T) followed by their mirrors T - 1 - t, cut to n."""
        t = torch.randint(0, num_timesteps, (n // 2 + 1,), device=self.device,
                          generator=generator if generator is not None else self.generator)
        return torch.cat([t, num_timesteps - 1 - t])[:n]

    @staticmethod
    @torch.no_grad()
    def init_like_flax(module: nn.Module) -> None:
        """Flax's default initialisers, drawn from the global stream: Dense
        kernels lecun-normal and Conv kernels (the Projector's
        ``series_conv_kernel`` too) he-normal, both truncated at two standard
        deviations; biases zero; LayerNorm scale one. The gate tables of
        ``ConditionalLinear`` keep their own U(0, 1)."""

        def truncated(w, fan_in, scale):
            # the standard normal truncated to (-2, 2) has std .8796...
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0)
            w.mul_(math.sqrt(scale / fan_in) / 0.87962566103423978)

        for name, m in module.named_modules():
            if isinstance(m, nn.Linear):
                truncated(m.weight, m.in_features, 1.0)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                truncated(m.weight, m.in_channels * m.kernel_size[0], 2.0)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, prm in module.named_parameters():
            if name.endswith("series_conv_kernel"):  # [1, S, k]: fan_in S * k
                truncated(prm, prm.shape[1] * prm.shape[2], 2.0)
