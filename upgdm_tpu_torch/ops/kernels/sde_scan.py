"""K4 — one Euler–Maruyama segment in one launch (wrapper of
``csrc/sde_scan.cu``).

Counterpart of ``upgdm_tpu/data/sde.py::_segment_scan`` (a ``lax.scan``, not a
Pallas kernel). From y0 [D] and the segment's control values eps [n] it runs

    y <- y + drift(y, eps[k]) * dt + sigma * sqrt(dt) * dw_k     k = 0 .. n-1

and returns ``(y_end [D], ys [n // save_every, D])``: every
``save_every``-th state of the segment, the JAX package's per-segment
decimation. ``drift`` is a ``data.sde.SystemDrift`` (its ``system``,
``params``, ``adj`` and ``deg``; on the CPU it is called, on the card the
kernel computes the same drift). ``noise="additive"`` draws dw as one standard
normal per feature (SLBP); ``"scale_mixture"`` as the product z1 * z2 of two
(the networked systems).

The increments come from Philox4x32-10 keyed by ``seed`` with counter (node,
``stream``, global step, 0) for the scale mixture (z1, z2 the cosine and sine
halves of one Box-Muller pair) and (0, ``stream``, global step, f // 2) for
additive feature f: ``chain_resident.philox_normal_reference``'s transform,
so the plain twin ``sde_scan_reference`` draws what the kernel draws. The
segment's first step is global step ``step0``: a trajectory does not depend
on how it is cut into segments. The twin's ``increments`` seam takes
precomputed increments [n, D] instead (the tests feed it JAX's).

``sde_scan`` launches the kernel for CUDA tensors and runs the twin for CPU
tensors; it counts its launches in ``.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .chain_resident import philox_normal_reference
from .fused_denoiser import _check_mat

__all__ = [
    "STREAM_INIT",
    "STREAM_BURN",
    "STREAM_RUN",
    "kernel_constants",
    "philox_increments",
    "sde_scan",
    "sde_scan_reference",
]

STREAM_INIT, STREAM_BURN, STREAM_RUN = 0, 1, 2
_SYSTEMS = {"biomass": 0, "SIS": 1, "neuronal": 2, "SLBP": 3}
_NOISE = ("additive", "scale_mixture")
_COUNTERS = 1 << 20  # Philox counters a twin call draws at once
_CONSTANTS = {"biomass": ("r", "k", "d"), "SIS": ("d",), "neuronal": ("tau", "mu")}


def kernel_constants(drift) -> np.ndarray:
    """The drift's constants as ``csrc/sde_scan.cu`` reads them (float32),
    each rounded once from the float64 value the twin's Python arithmetic
    gives it."""
    p = drift.params
    if drift.system == "SLBP":
        vals = (p["i_b"], p["i_p"], p["r"], p["H1"], p["H2"], p["K"] * p["H3"] ** 2,
                p["H3"] ** 2, p["H4"] ** 2, p["c_b"], p["c_p"], p["p_r"], p["c_e"] * p["p_r"],
                p["m_p"])
    else:
        vals = tuple(p[k] for k in _CONSTANTS[drift.system])
    return np.asarray(vals, np.float32)


def philox_increments(seed: int, stream: int, step0: int, n: int, D: int, noise: str,
                      device=None) -> torch.Tensor:
    """The increments K4 draws for global steps step0 .. step0 + n - 1: float32
    [n, D] (the normal, or the product of the pair for ``"scale_mixture"``)."""
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    per = max(1, _COUNTERS // D)
    for a in range(0, n, per):
        b = min(n, a + per)
        steps = torch.arange(step0 + a, step0 + b, dtype=torch.int64, device=device)
        if noise == "additive":
            rows = torch.full_like(steps, int(stream) << 32)
            out[a:b] = philox_normal_reference(seed, rows, steps, D)
        else:
            node = torch.arange(D, dtype=torch.int64, device=device)
            rows = ((int(stream) << 32) + node).repeat(b - a)
            z = philox_normal_reference(seed, rows, steps.repeat_interleave(D), 2)
            out[a:b] = (z[:, 0] * z[:, 1]).reshape(b - a, D)
    return out


def sde_scan_reference(drift, y0, eps, sigma, dt, seed, stream, step0=0, save_every=1,
                       noise="additive", increments=None):
    """Plain PyTorch twin of K4: the step loop over ``drift`` on the device of
    ``y0``. ``increments`` [n, D], if given, replaces the Philox draws."""
    if noise not in _NOISE:
        raise ValueError(f"noise={noise!r}: expected one of {_NOISE}")
    n, D = int(eps.shape[0]), int(y0.shape[0])
    dev = y0.device
    dt32 = torch.tensor(dt, dtype=torch.float32, device=dev)
    scale = sigma * torch.sqrt(dt32)
    ys = torch.empty((n // save_every, D), dtype=torch.float32, device=dev)
    y = y0
    per = max(1, _COUNTERS // D)
    for a in range(0, n, per):
        b = min(n, a + per)
        inc = (increments[a:b] if increments is not None
               else philox_increments(seed, stream, step0 + a, b - a, D, noise, dev))
        for k in range(a, b):
            y = y + drift(y, eps[k]) * dt32 + scale * inc[k - a]
            if (k + 1) % save_every == 0:
                ys[(k + 1) // save_every - 1] = y
    return y, ys


def sde_scan(drift, y0, eps, sigma, dt, seed, stream, step0=0, save_every=1,
             noise="additive", increments=None):
    """One segment: y0 [D], eps [n], sigma [D] (float32) -> (y_end [D],
    ys [n // save_every, D]). CUDA tensors launch K4 (which draws its own
    noise, so ``increments`` is for the twin only); CPU tensors run the twin.
    """
    if y0.device.type == "cpu":
        return sde_scan_reference(drift, y0, eps, sigma, dt, seed, stream, step0, save_every,
                                  noise, increments)
    if y0.device.type != "cuda":
        raise ValueError(f"sde_scan: unsupported device {y0.device}")
    if increments is not None:
        raise ValueError("sde_scan: K4 draws its own increments; increments= is the twin's seam")
    if noise not in _NOISE:
        raise ValueError(f"noise={noise!r}: expected one of {_NOISE}")
    if drift.system not in _SYSTEMS:
        raise ValueError(f"unknown system {drift.system!r}")
    dev = y0.device
    D, n = int(y0.shape[0]), int(eps.shape[0])
    if save_every < 1 or step0 < 0 or step0 + n > 2**32:
        raise ValueError(f"save_every={save_every}, steps {step0}..{step0 + n}: the Philox "
                         "step word holds 32 bits")
    _check_mat("y0", y0, (D,), torch.float32, dev)
    _check_mat("eps", eps, (n,), torch.float32, dev)
    _check_mat("sigma", sigma, (D,), torch.float32, dev)
    network = drift.system != "SLBP"
    if network:
        adjT = drift.adj.t().contiguous()
        _check_mat("adj", adjT, (D, D), torch.float32, dev)
        _check_mat("deg", drift.deg, (D,), torch.float32, dev)
    elif D != 2:
        raise ValueError(f"SLBP has two states, got y0 [{D}]")
    consts = kernel_constants(drift)
    y_end = torch.empty(D, dtype=torch.float32, device=dev)
    ys = torch.empty((n // save_every, D), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    ptr = lambda t: None if t is None else t.data_ptr()
    code = lib.upgdm_sde_scan(
        _SYSTEMS[drift.system], int(noise == "scale_mixture"), D, n, int(save_every),
        ptr(y0), ptr(eps), ptr(sigma), ptr(adjT) if network else None,
        ptr(drift.deg) if network else None, consts.ctypes.data, len(consts),
        float(np.float32(dt)), float(np.sqrt(np.float32(dt))), int(seed) & (2**64 - 1),
        int(stream), int(step0), ptr(y_end), ptr(ys),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "sde_scan")
    sde_scan.launches += 1
    return y_end, ys


sde_scan.launches = 0
