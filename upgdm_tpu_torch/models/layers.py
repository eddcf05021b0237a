"""Linear, Conv1d and LayerNorm that compute in the promoted type of their
input and parameters, as flax's layers do (``flax.linen.dtypes.promote_dtype``
under ``dtype=None``).

Torch's own layers refuse an input whose type differs from their weights'.
Flax promotes instead: a bf16 kernel meeting a float32 input computes in
float32 on the kernel's bf16 values. The JAX package's bf16 training relies
on it (``train/loop.py:54-67`` casts the parameters to bf16, and a float32
constant such as the positional table then lifts the activations back to
float32), so the port's modules do the same. With one type throughout these
are torch's layers: ``Tensor.to`` of the same type is the tensor itself.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["promote", "Linear", "Conv1d", "LayerNorm", "gelu", "gelu2"]


def promote(*tensors):
    """The tensors (``None`` passes) cast to their promoted floating type."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in tensors if t is not None))
    return tuple(None if t is None else t.to(dt) for t in tensors)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(*promote(x, self.weight, self.bias))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def gelu(x):
    """torch ``nn.GELU``: the exact erf form (flax's default is the tanh
    approximation; DiffusionTS asks for the exact one)."""
    return F.gelu(x)


def gelu2(x):
    """DiffusionTS's GELU2, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)
