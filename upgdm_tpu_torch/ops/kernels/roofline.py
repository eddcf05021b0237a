"""The least time the card could take for one call of a kernel, from the work
its shapes imply: the largest of three terms,

* bytes over the memory rate (each input read once, each output written once),
* matrix operations over the peak rate for the matmul type,
* special-function results (``exp``, ``log``, ``rsqrt``) over the rate of
  the special-function unit: 16 results a clock on each SM.

The peaks are the H100 SXM data sheet's dense rates. ``chip_smoke.py`` and
``PERF.md`` state every kernel's time beside this bound.
"""
from __future__ import annotations

from typing import Tuple

__all__ = [
    "PEAK_FLOPS", "PEAK_BYTES", "SFU_PER_CLOCK_PER_SM", "SM_COUNT", "bound_ms",
    "k1_work", "k2_work", "k3_work",
]

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16
SM_COUNT = 132
HID = 128


def bound_ms(flops: float, nbytes: float, sfu: float, matmul_dtype: str,
             sm_clock_hz: float) -> Tuple[float, str]:
    """(milliseconds, which term binds) for ``flops`` matrix operations in
    ``matmul_dtype``, ``nbytes`` of device-memory traffic and ``sfu``
    special-function results at an SM clock of ``sm_clock_hz``."""
    terms = {
        "operations": flops / PEAK_FLOPS[matmul_dtype],
        "bytes": nbytes / PEAK_BYTES,
        "special_functions": sfu / (SFU_PER_CLOCK_PER_SM * SM_COUNT * sm_clock_hz),
    }
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def _softplus(n: float) -> float:
    return 2.0 * n  # one exp and one log each


def k1_work(M: int, F: int = 1) -> Tuple[float, float, float]:
    """(flops, bytes, special-function results) of one K1 call on M rows:
    x [M, 3F] in, eps and sigma [M, F] out; per row 4 x 128 + F softplus
    (three layers, the sigma head's input and output) and three rsqrt."""
    flops = 2.0 * M * (3 * F * HID + 2 * HID * HID + 2 * HID * F)
    nbytes = 4.0 * M * (3 * F + 2 * F)
    sfu = M * (_softplus(4 * HID + F) + 3)
    return flops, nbytes, sfu


def k2_work(M: int, T: int, F: int = 1) -> Tuple[float, float, float]:
    """One K2 call: the T-step chain on M rows. y0_hat and gx [M, F] in, y_0
    out; the first layer's y0_hat/gx partials once, then T steps of the K1
    trunk and heads. Per (row, step, feature) the chain also needs seven
    special-function results: the normal's log, root and cosine or sine, the
    roots of the quadratic's discriminant, of noise_var and of sigma_theta,
    and the reciprocal of the posterior's denominator (the other divisors
    depend on the step alone). At F = 1 they add 7 to the trunk's 1,029."""
    flops = 2.0 * M * (2 * F * HID + T * (F * HID + 2 * HID * HID + 2 * HID * F))
    nbytes = 4.0 * M * 3 * F
    sfu = T * M * (_softplus(4 * HID + F) + 3 + 7 * F)
    return flops, nbytes, sfu


def k3_work(M: int, F: int = 1) -> Tuple[float, float, float]:
    """One K3 call on M rows: x [M, 2F] in, eps [M, F] out; per row 3 x 128
    softplus and no norm."""
    flops = 2.0 * M * (2 * F * HID + 2 * HID * HID + HID * F)
    nbytes = 4.0 * M * (2 * F + F)
    sfu = M * _softplus(3 * HID)
    return flops, nbytes, sfu
