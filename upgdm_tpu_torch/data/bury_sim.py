"""Bury-2021-style training simulations for the real-data "simulation" model.

Counterpart of ``upgdm_tpu/data/bury_sim.py``: numpy on the host, as in the
JAX package, on the port's ``eval/ews_classic.py::lowess_smooth``; the same
seed gives the same corpus bit for bit. The protocol reconstructs the
simulation archive of Bury et al. 2021 (PNAS, "Deep learning for early
warning signals of tipping points"): 500-point residual series of generic 1-D
systems forced slowly through a local bifurcation, plus neutral (null) runs:

  - fold:          dx = (mu + x^2) dt + sigma dW, mu: -mu0 -> 0 (tips at 0)
  - transcritical: dx = (mu x - x^2) dt + sigma dW, mu: -mu0 -> 0
  - pitchfork:     dx = (mu x - x^3) dt + sigma dW, mu: -mu0 -> 0
  - null:          same forms with mu FIXED at -mu0 (no forcing)

Each series integrates with Euler-Maruyama at a per-series random timescale
and noise level, keeps the pre-bifurcation segment, Lowess-detrends it, and
standardizes the residuals, giving ``ts_500/pt/*.pt`` records shaped like the
real-data loaders expect.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..eval.ews_classic import lowess_smooth
from ..utils.io import save_pt

__all__ = ["simulate_bury_series", "generate_bury_training_corpus"]

_FORMS = ("fold", "transcritical", "pitchfork")


def _drift(form: str, x: float, mu: float) -> float:
    if form == "fold":
        return mu + x * x
    if form == "transcritical":
        return mu * x - x * x
    if form == "pitchfork":
        return mu * x - x**3
    raise ValueError(f"unknown bifurcation form {form!r}")


def _stable_root(form: str, mu: float) -> float:
    # stable equilibrium for mu < 0 (the branch the forced run starts on)
    if form == "fold":
        return -np.sqrt(max(-mu, 1e-12))
    return 0.0


def simulate_bury_series(
    form: str,
    forced: bool,
    n_points: int = 500,
    rng: Optional[np.random.Generator] = None,
    dt: float = 0.01,
    oversample: int = 10,
) -> np.ndarray:
    """One detrended, standardized residual series [n_points] float32.

    ``forced`` ramps mu from -mu0 to 0 over the simulation (the series ends
    AT the bifurcation, like Bury's truncated-at-transition training runs);
    unforced runs keep mu at -mu0.  Noise and ramp depth are randomized per
    series so the corpus spans a range of proximity-to-tipping dynamics.
    """
    rng = rng or np.random.default_rng(0)
    mu0 = float(rng.uniform(0.3, 1.5))
    sigma = float(rng.uniform(0.01, 0.08))
    n_steps = n_points * oversample
    mu_path = (
        np.linspace(-mu0, 0.0, n_steps) if forced else np.full(n_steps, -mu0)
    )
    x = _stable_root(form, -mu0) + rng.normal() * sigma
    out = np.empty(n_points, np.float64)
    sq = np.sqrt(dt)
    noise = rng.normal(size=n_steps)
    j = 0
    for i in range(n_steps):
        x = x + _drift(form, x, mu_path[i]) * dt + sigma * sq * noise[i]
        # clamp runaway post-tip excursions (fold escapes to +inf fast)
        x = min(max(x, -50.0), 50.0)
        if (i + 1) % oversample == 0:
            out[j] = x
            j += 1
    resid = out - lowess_smooth(out, span=0.2)
    std = resid.std()
    if std > 1e-12:
        resid = resid / std
    return resid.astype(np.float32)


def generate_bury_training_corpus(
    out_dir,
    n_series: int = 96,
    n_points: int = 500,
    seed: int = 0,
    forced_fraction: float = 0.75,
) -> list:
    """Write <out_dir>/ts_500/pt/<form>_<forced|null>_<k>.pt records.

    Record layout matches the real-data loader contract: ``ys_dynamic``
    [n_points, 1], ``ts_dynamic`` [n_points].  Existing files are kept
    (exists() resume, like the zoo data stage).
    """
    out = Path(out_dir) / f"ts_{n_points}" / "pt"
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for k in range(n_series):
        form = _FORMS[k % len(_FORMS)]
        forced = (k / max(n_series, 1)) < forced_fraction
        path = out / f"{form}_{'forced' if forced else 'null'}_{k:03d}.pt"
        # burn the per-series RNG draws even on resume so the corpus is
        # deterministic regardless of which files already exist
        series_rng = np.random.default_rng(rng.integers(2**63))
        if path.exists():
            written.append(path)
            continue
        series = simulate_bury_series(form, forced, n_points, series_rng)
        save_pt(
            {
                "name": path.stem,
                "ys_dynamic": series[:, None],
                "ts_dynamic": np.arange(n_points, dtype=np.float32),
                "data_type": f"bury_sim_{form}",
            },
            path,
        )
        written.append(path)
    return written
