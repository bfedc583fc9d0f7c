"""Feature scalers in numpy (counterpart of ``zdcsim/data/scalers.py``):
the sklearn ``StandardScaler`` and ``MinMaxScaler`` the reference uses,
without sklearn. Fit in float64, transform to float32; a column of zero
variance or range maps to scale 1, as in sklearn."""

from __future__ import annotations

from typing import Optional

import numpy as np


class StandardScaler:
    """Zero mean, unit variance per column (population std, like sklearn)."""

    def __init__(self):
        self.mean_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        std = x.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x, np.float64) - self.mean_) / self.scale_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) * self.scale_ + self.mean_).astype(np.float32)


class MinMaxScaler:
    """Scale each column to [0, 1] (sklearn's default range)."""

    def __init__(self):
        self.min_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None  # 1 / (max - min)

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        x = np.asarray(x, np.float64)
        lo = x.min(axis=0)
        rng = x.max(axis=0) - lo
        self.min_ = lo
        self.scale_ = np.where(rng == 0.0, 1.0, 1.0 / np.where(rng == 0.0, 1.0, rng))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x, np.float64) - self.min_) * self.scale_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) / self.scale_ + self.min_).astype(np.float32)
