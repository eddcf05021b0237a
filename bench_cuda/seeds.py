"""Every stream of a run is derived from ``--seed`` and a label, so the same
seed gives the same weights, inputs, noise and samples. Seeds of any size
(beyond 32 bits too) are taken whole."""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["derive", "rng"]


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from the run's seed
    and the labels of one stream."""
    text = repr((int(seed),) + tuple(str(x) for x in labels)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *labels) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *labels))
