"""Feature scalers with the reference's exact semantics.

Counterpart of ``upgdm_tpu/utils/scalers.py`` (numpy only): flat series take
their statistics over axis 0, graph batches over axes (0, 1); zero stds are
replaced by 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StandardScaler"]


@dataclasses.dataclass
class StandardScaler:
    mean: np.ndarray = None
    std: np.ndarray = None

    def fit(self, data, axis=0) -> "StandardScaler":
        data = np.asarray(data)
        std = data.std(axis=axis)
        mean = data.mean(axis=axis)
        std = np.where(std == 0, 1.0, std)
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        return self

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean
