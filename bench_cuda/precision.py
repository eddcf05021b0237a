"""The arithmetic of the reference and of its control.

The reference runs the denoisers' products in the precision the
configuration states for them (``sampling_matmul_dtype``, else
``sampling_dtype``, else bfloat16, as the program reads it): bfloat16
operands with float32 sums, or float32; everything else in float32 with TF32
off. The control steps one precision below: float8 e4m3 operands scaled per
tensor for bfloat16 products, TF32 for float32 ones and for the rest."""
from __future__ import annotations

import contextlib

import torch

from .reference.blocks import f32_mm

__all__ = ["bf16_mm", "fp8_mm", "f32_mm", "stated", "tf32", "REFERENCE_MM", "CONTROL_MM"]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(a, w):
    return _fp8(a) @ _fp8(w)


def bf16_mm(a, w):
    return a.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)


def stated(net: dict) -> str:
    """The denoisers' product type a configuration states."""
    return str(net.get("sampling_matmul_dtype", net.get("sampling_dtype", "bfloat16")))


REFERENCE_MM = {"float32": f32_mm, "bfloat16": bf16_mm}
CONTROL_MM = {"float32": f32_mm, "bfloat16": fp8_mm}  # float32's control is TF32 (``tf32``)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off inside; the process's settings again after."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved
