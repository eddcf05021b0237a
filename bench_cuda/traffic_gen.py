"""The one generator that reads every traffic file (``traffic/<name>.json``).

``trajectories``: a pool of seeded trajectories of ``nodes`` series, each a
linear trend from ``level[0]`` to ``level[1]`` plus Gaussian noise of
standard deviation ``noise`` (the recipe of the repository's sweep benches),
cut into ``windows`` rolling windows ``stride`` steps apart:
``[windows, nodes, W, F]`` float32 arrays, as users hand them to a sweep.
Every seed gives the same sizes; only the values change.

``corpus``: ``corpus_windows`` windows of W + P steps cut from seeded
trajectories of the same recipe, ``corpus_stride`` apart, standardised over
the corpus as the training loop's scaler does, for training.
"""
from __future__ import annotations

import numpy as np

from .seeds import rng

__all__ = ["trajectories", "corpus", "scaler_of"]


def _series(g: np.random.Generator, n: int, T: int, F: int, traffic: dict) -> np.ndarray:
    lo, hi = traffic["level"]
    traj = g.normal(size=(n, T, F)) * traffic["noise"]
    traj += np.linspace(lo, hi, T)[None, :, None]
    return traj.astype(np.float32)


def trajectories(traffic: dict, net: dict, seed: int):
    W, F = net["windows"], net["dataset_nf"]
    n, stride, nodes = traffic["windows"], traffic["stride"], traffic["nodes"]
    T = W + (n - 1) * stride + 1
    idx = (np.arange(n) * stride)[:, None] + np.arange(W)[None, :]
    pool = []
    for p in range(traffic["pool"]):
        traj = _series(rng(seed, "trajectory", p), nodes, T, F, traffic)
        pool.append(np.ascontiguousarray(traj[:, idx, :].transpose(1, 0, 2, 3)))
    return pool


def corpus(traffic: dict, net: dict, seed: int) -> np.ndarray:
    L = net["windows"] + net["pred_len"]
    n, stride = traffic["corpus_windows"], traffic["corpus_stride"]
    per = traffic["corpus_series_windows"]
    out = []
    for s in range(-(-n // per)):
        T = L + (per - 1) * stride
        traj = _series(rng(seed, "corpus", s), 1, T, net["dataset_nf"], traffic)[0]
        idx = (np.arange(per) * stride)[:, None] + np.arange(L)[None, :]
        out.append(traj[idx])
    x = np.concatenate(out)[:n].astype(np.float64)
    x = (x - x.mean()) / x.std()
    return np.ascontiguousarray(x.astype(np.float32))


def scaler_of(pool) -> tuple:
    """(mean [F], std [F]) of the pool's first trajectory: the scaler a model
    trained on such data holds."""
    x = pool[0].reshape(-1, pool[0].shape[-1]).astype(np.float64)
    return x.mean(axis=0).astype(np.float32), x.std(axis=0).astype(np.float32)
