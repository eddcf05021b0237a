"""SDE trajectory simulators: Euler–Maruyama on the card, one kernel launch a
segment.

Counterpart of ``upgdm_tpu/data/sde.py``. The four systems and their drifts
are the JAX package's:

  - biomass:  dx_i = r x_i (1 - x_i/k) - eps(t) x_i^2/(x_i^2+1)
              + d * (A x - deg * x) + eta dW_i
  - SIS:      dx_i = -d x_i + eps(t) (1 - x_i) [A x]_i + eta dW_i
  - neuronal: dx_i = -x_i + (1 - eps(t)) [A sigmoid(tau (x - mu))]_i + eta dW_i
  - SLBP:     the 2-state bream/pike lake model with additive noise
              (sqrt(2D), sqrt(0.2 D))

The drifts below are plain functions on float32 tensors in the JAX source's
order of operations; they are the plain twin's arithmetic
(``ops/kernels/sde_scan.py::sde_scan_reference``). Where the JAX package
integrates a segment with one compiled ``lax.scan``, the port launches one
CUDA kernel (K4, ``csrc/sde_scan.cu``) a segment; on the CPU the twin runs the
same steps. The host part is JAX's: burn-in at ``burn_control``,
``n_total = int(total_time / dt)`` steps in segments of
``max_segment_steps``, ``ts`` from a float64 ``linspace``, the control values
cast to float32, and the decimation taken per segment (states) but globally
(times and controls), so with a ``max_segment_steps`` that ``save_every`` does
not divide the saved states and their times drift apart, as in JAX.

Noise. The JAX package draws ``jax.random`` normals; the port draws
Philox4x32-10 normals keyed by the seed, with counter (node or feature,
stream, global step): a trajectory depends on (seed, stream, step, node)
only, never on ``max_segment_steps`` or the launch shape. The initial state
draws from stream 0, the burn-in from stream 1 and the run from stream 2; a
networked system's retry ``a`` keys with ``seed * 1000 + a``, as JAX keys its
retries. The two packages agree in distribution, not per sample; the tests
hold the port to JAX per sample on JAX's own normals (the ``increments``
seam of ``simulate_sde``).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.kernels.chain_resident import philox4x32_10
from ..ops.kernels.sde_scan import STREAM_BURN, STREAM_INIT, STREAM_RUN, sde_scan
from ..utils.device import resolve_device

__all__ = [
    "simulate_sde",
    "biomass_drift",
    "sis_drift",
    "neuronal_drift",
    "slbp_drift",
    "SystemDrift",
    "simulate_network_system",
    "simulate_slbp",
    "philox_uniform",
    "SLBP_DEFAULT_PARAMS",
]


# ---------------------------------------------------------------------------
# Drift functions (y: [N] float32 state; eps: scalar control parameter)
# ---------------------------------------------------------------------------

def _c(like: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 constant on ``like``'s device. Dividing by it is a true
    division on every device (PyTorch multiplies by the reciprocal of a
    Python-number divisor on CUDA, and of a Python-number dividend
    everywhere)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def biomass_drift(y, eps, adj, deg, r=1.0, k=10.0, d=0.05):
    y = torch.clamp(y, min=0.0)
    logistic = r * y * (1.0 - y / _c(y, k))
    harvesting = -eps * (y * y) / (y * y + 1.0)
    diffusion = d * (adj @ y - deg * y)
    return logistic + harvesting + diffusion


def sis_drift(y, eps, adj, d=1.0):
    return -d * y + eps * (1.0 - y) * (adj @ y)


def neuronal_drift(y, eps, adj, tau=2.0, mu=1.5):
    """Wilson–Cowan-style networked neuronal dynamics (mu=1.5 places the
    sigmoid threshold where the coupled high-activity branch exists, so
    ramping eps 0->1 tips it)."""
    return -y + (1.0 - eps) * (adj @ torch.sigmoid(tau * (y - mu)))


SLBP_DEFAULT_PARAMS: Dict[str, float] = {
    "i_b": 3e-4, "i_p": 3e-4, "r": 7.5e-3, "H1": 0.5, "H2": 0.1, "H3": 20.0,
    "H4": 15.0, "c_b": 7.5e-5, "c_p": 2.75e-4, "p_r": 5e-2, "c_e": 0.1,
    "m_p": 2.25e-3, "K": 1.0, "D": 1e-5,
}


def slbp_drift(y, n_level, p):
    """Bream/pike drift; y = [X, Y]; n_level = nutrient control N(t). Products
    of parameters are taken in float64 and rounded once, as Python evaluates
    them in the JAX source."""
    X, Y = y[0], y[1]
    V = torch.div(_c(X, p["K"] * p["H3"] ** 2), X * X + p["H3"] ** 2)
    F_R = X * X / (X * X + p["H4"] ** 2)
    dX = (
        p["i_b"]
        + p["r"] * X * (n_level / (n_level + p["H1"]))
        - p["c_b"] * (X * X)
        - p["p_r"] * F_R * Y
    )
    dY = (
        p["i_p"]
        + p["c_e"] * p["p_r"] * F_R * Y * (V / (V + p["H2"]))
        - p["m_p"] * Y
        - p["c_p"] * (Y * Y)
    )
    return torch.stack([dX, dY])


_DRIFTS = {"biomass": biomass_drift, "SIS": sis_drift, "neuronal": neuronal_drift}


class SystemDrift:
    """One of the four drifts with its parameters bound, as the JAX package
    binds them with ``functools.partial``: ``drift(y, eps)``. ``params``
    holds every parameter, the drift's defaults filled in (SLBP:
    ``SLBP_DEFAULT_PARAMS``); K4 reads the system's name, the parameters and
    the adjacency from it."""

    def __init__(self, system: str, adj=None, **params):
        if system == "SLBP":
            defaults = SLBP_DEFAULT_PARAMS
        elif system in _DRIFTS:
            defaults = {k: v.default for k, v in
                        inspect.signature(_DRIFTS[system]).parameters.items()
                        if v.default is not inspect.Parameter.empty}
        else:
            raise ValueError(f"unknown system {system!r}")
        self.system = system
        self.params = {**defaults, **params}
        self.adj = None if adj is None else torch.as_tensor(np.asarray(adj, np.float32))
        self.deg = None if adj is None else self.adj.sum(dim=1)

    def to(self, device) -> "SystemDrift":
        out = SystemDrift.__new__(SystemDrift)
        out.system, out.params = self.system, self.params
        out.adj = None if self.adj is None else self.adj.to(device)
        out.deg = None if self.deg is None else self.deg.to(device)
        return out

    def __call__(self, y, eps):
        if self.system == "SLBP":
            return slbp_drift(y, eps, self.params)
        if self.system == "biomass":
            return biomass_drift(y, eps, self.adj, self.deg, **self.params)
        return _DRIFTS[self.system](y, eps, self.adj, **self.params)


# ---------------------------------------------------------------------------
# Generic Euler–Maruyama engine
# ---------------------------------------------------------------------------

def philox_uniform(seed: int, n: int) -> np.ndarray:
    """n float32 uniforms in [0, 1) from stream 0 (``STREAM_INIT``) at step 0:
    the initial state of a trajectory. Counter (i, stream, 0, 0), 24 bits of
    the first word."""
    i = torch.arange(n, dtype=torch.int64)
    zero = torch.zeros_like(i)
    seed = int(seed) & (2**64 - 1)
    key = (torch.full_like(i, seed & 0xFFFFFFFF), torch.full_like(i, seed >> 32))
    b0, _, _, _ = philox4x32_10((i, torch.full_like(i, STREAM_INIT), zero, zero), key)
    return ((b0 >> 8).double() / 16777216.0).numpy().astype(np.float32)


def simulate_sde(
    drift: SystemDrift,
    y0: np.ndarray,
    sigma,
    control_fn: Callable[[np.ndarray], np.ndarray],
    total_time: float,
    dt: float,
    key: int,
    burn_time: float = 0.0,
    burn_control: float = 0.0,
    max_segment_steps: int = 1_000_000,
    save_every: int = 1,
    noise: str = "additive",
    device=None,
    increments: Optional[Iterable] = None,
):
    """Burn-in + segmented integration; returns (ts, ys, control_values) as
    numpy arrays, as the JAX package's ``simulate_sde``.

    ``key`` is the integer seed of the Philox stream. ``increments`` (the
    tests' seam) replaces the Philox draws: an iterable of [n, D] arrays of
    noise increments (the normal, or for ``"scale_mixture"`` the product of
    two), consumed in order by the burn-in and then each segment. ``device``
    None means the card.
    """
    dev = resolve_device(device)
    drift = drift.to(dev)
    y = torch.as_tensor(np.asarray(y0, np.float32), device=dev)
    sig = torch.as_tensor(np.asarray(sigma, np.float32), device=dev).expand(y.shape).contiguous()
    seed = int(key)
    incs = None if increments is None else iter(increments)

    def scan(y, eps, stream, step0, every):
        inc = None if incs is None else torch.as_tensor(np.asarray(next(incs), np.float32),
                                                        device=dev)
        return sde_scan(drift, y, eps, sig, dt, seed, stream, step0, every, noise, inc)

    n_burn = int(burn_time / dt)
    if n_burn > 0:
        eps_burn = torch.full((n_burn,), burn_control, dtype=torch.float32, device=dev)
        y, _ = scan(y, eps_burn, STREAM_BURN, 0, n_burn)

    n_total = int(total_time / dt)
    ts = np.linspace(0.0, total_time, n_total, dtype=np.float64)
    eps_all = np.asarray(control_fn(ts), np.float32)
    eps_dev = torch.as_tensor(eps_all, device=dev)

    ys_parts = []
    for start in range(0, n_total, max_segment_steps):
        n_seg = min(max_segment_steps, n_total - start)
        y, ys = scan(y, eps_dev[start:start + n_seg], STREAM_RUN, start, save_every)
        ys_parts.append(ys.cpu().numpy())
    ys = np.concatenate(ys_parts, axis=0)
    if save_every > 1:
        ts = ts[save_every - 1 :: save_every][: ys.shape[0]]
        eps_all = eps_all[save_every - 1 :: save_every][: ys.shape[0]]
    return ts, ys, eps_all


# ---------------------------------------------------------------------------
# System-level wrappers with divergence guard + retry
# ---------------------------------------------------------------------------

def _linear_ramp(lo, hi, trend, total_time):
    if trend == "increase":
        return lambda t: lo + (hi - lo) * (t / total_time)
    if trend == "decrease":
        return lambda t: hi - (hi - lo) * (t / total_time)
    raise ValueError("trend should be 'increase' or 'decrease'")


def simulate_network_system(
    system: str,
    adj: np.ndarray,
    trend: str = "increase",
    control_range=(0.0, 1.0),
    base_params: Optional[dict] = None,
    eta: float = 0.05,
    total_time: float = 1e4,
    burn_time: float = 100.0,
    dt: float = 0.1,
    seed: int = 0,
    max_retries: int = 10,
    save_every: int = 1,
    constant_control: Optional[float] = None,
    device=None,
) -> dict:
    """One networked trajectory record {ys_dynamic [T, Node], ts_dynamic,
    tp_values} with the divergence-guarded retry loop: the per-timestep node
    mean (float64) must stay finite and inside (-10, 100) over the whole
    record, else the next of ``max_retries`` attempts runs.

    ``constant_control`` gives the *_contant null datasets (control fixed for
    the whole run). ``device`` None means the card."""
    if system not in ("biomass", "SIS", "neuronal"):
        raise ValueError(f"unknown system {system!r}")
    dev = resolve_device(device)
    drift = SystemDrift(system, adj, **(base_params or {}))

    lo, hi = control_range
    if constant_control is not None:
        control_fn = lambda t: np.full_like(np.asarray(t, np.float64), constant_control)
        burn_control = constant_control
    else:
        control_fn = _linear_ramp(lo, hi, trend, total_time)
        burn_control = lo if trend == "increase" else hi

    N = drift.adj.shape[0]
    for attempt in range(max_retries):
        key = seed * 1000 + attempt
        ts, ys, eps = simulate_sde(
            drift, philox_uniform(key, N), eta, control_fn, total_time, dt, key,
            burn_time=burn_time, burn_control=burn_control, save_every=save_every,
            noise="scale_mixture", device=dev,
        )
        mean_t = np.asarray(ys, np.float64).mean(axis=1)
        if np.isfinite(mean_t).all() and mean_t.max() < 100.0 and mean_t.min() > -10.0:
            return {
                "ys_dynamic": ys.astype(np.float32),  # [T, Node]
                "ts_dynamic": ts.astype(np.float32),
                "tp_values": eps.astype(np.float32),
            }
    raise RuntimeError(f"simulation diverged after {max_retries} retries ({system})")


def simulate_slbp(
    params: Optional[dict] = None,
    trend: str = "increase",
    n_range=(0.0, 3.5),
    total_time: float = 1e6,
    burn_time: float = 1000.0,
    dt: float = 0.1,
    seed: int = 0,
    save_every: int = 1,
    constant_n: Optional[float] = None,
    device=None,
) -> dict:
    """One SLBP trajectory record {ys_dynamic [T, 2], ts_dynamic, N_values}.
    ``device`` None means the card."""
    p = dict(SLBP_DEFAULT_PARAMS)
    if params:
        p.update(params)
    sigma = np.array([(2 * p["D"]) ** 0.5, (0.2 * p["D"]) ** 0.5], np.float32)

    lo, hi = n_range
    if constant_n is not None:
        control_fn = lambda t: np.full_like(np.asarray(t, np.float64), constant_n)
        burn_control = constant_n
    else:
        control_fn = _linear_ramp(lo, hi, trend, total_time)
        burn_control = lo if trend == "increase" else hi

    ts, ys, n_values = simulate_sde(
        SystemDrift("SLBP", **p), philox_uniform(seed, 2), sigma, control_fn, total_time,
        dt, seed, burn_time=burn_time, burn_control=burn_control, save_every=save_every,
        device=device,
    )
    return {
        "ys_dynamic": ys.astype(np.float32),  # [T, 2]
        "ts_dynamic": ts.astype(np.float32),
        "N_values": np.asarray(n_values, np.float32),
    }
