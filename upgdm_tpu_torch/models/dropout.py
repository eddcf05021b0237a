"""Dropout that draws its masks from an explicit ``torch.Generator``.

Counterpart of ``flax.linen.Dropout`` as the JAX package's backbones use it:
with ``gen=None`` (flax's ``deterministic=True``) or a rate of 0 the input
passes through unchanged; otherwise each element is kept with probability
1 - rate and scaled by 1 / (1 - rate). The masks come from the generator the
caller hands in (the model wrapper's), never from the global RNG, so a seed
fixes a whole training run; under a row shard (``parallel/draws.py``) the
mask is the global batch's, cut to the rank's rows.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import draws

__all__ = ["Dropout"]


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1]")
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if gen is None or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = draws.rand(x.shape, gen, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
