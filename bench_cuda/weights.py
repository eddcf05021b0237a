"""Seeded weights made on the device: one normal and one uniform draw for the
whole model, cut into the leaves that the reference's ``param_spec`` lists
and scaled by kind, in float32 (the type the program keeps them in).

Dense kernels are N(0, 1/fan_in), convolutions N(0, 2/fan_in) (fan_in of a
``[k, in, out]`` kernel is ``k * in``), biases N(0, 0.02^2), LayerNorm
scales 1 + N(0, 0.02^2), the denoisers' per-step gates U(0, 1): the scales
of flax's initialisers, with biases and norms off their trivial values so
that every leaf is exercised. One leaf is drawn smaller: the kernel that
gives the Non-stationary Transformer's log tau (``log_scale``, a tenth of
the Dense scale), so that tau stays near 1. At the Dense scale tau reached 26
on some seeds; the attention then saturates, and the float32 first gradient
of the tau learner, in the program and in the reference alike, lies 5% from
the float64 one: a comparison of float32 runs could not be decided there.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .seeds import derive

__all__ = ["make_weights", "host_copy"]


def _fan_in(shape) -> int:
    return int(np.prod(shape[:-1]))


def make_weights(spec: Iterable[Tuple[str, tuple, str]], seed: int, device) -> Dict[str, torch.Tensor]:
    spec = list(spec)
    normal = [(n, s, k) for n, s, k in spec if k != "gate"]
    gates = [(n, s, k) for n, s, k in spec if k == "gate"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in gates), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in normal:
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            v = v * (1.0 / math.sqrt(_fan_in(shape)))
        elif kind == "log_scale":
            v = v * (0.1 / math.sqrt(_fan_in(shape)))
        elif kind == "conv":
            v = v * math.sqrt(2.0 / _fan_in(shape))
        elif kind == "bias":
            v = v * 0.02
        elif kind == "scale":
            v = 1.0 + 0.02 * v
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = v
    at = 0
    for name, shape, _ in gates:
        n = math.prod(shape)
        out[name] = u[at:at + n].view(shape)
        at += n
    return out


def host_copy(weights: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The same leaves as numpy arrays, for a loader that takes them."""
    return {k: v.detach().cpu().numpy() for k, v in weights.items()}
