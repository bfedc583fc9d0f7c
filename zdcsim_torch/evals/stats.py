"""Per-image shower feature statistics (the port's own copy of
``zdcsim/evals/stats.py``, numpy)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def image_feature_stats(images: np.ndarray) -> Dict[str, np.ndarray]:
    """Shower statistics of linear-space images ``[N, H, W]``: the max
    pixel's (row, col), the intensity-weighted centres of mass and the count
    of non-zero pixels, each ``[N]``."""
    images = np.asarray(images)
    n, h, w = images.shape
    flat = images.reshape(n, h * w)
    arg = flat.argmax(axis=1)
    max_x, max_y = arg // w, arg % w

    total = flat.sum(axis=1)
    total_safe = np.where(total > 0, total, 1.0)
    rows = np.arange(h, dtype=np.float64)
    cols = np.arange(w, dtype=np.float64)
    center_x = (images.sum(axis=2) @ rows) / total_safe
    center_y = (images.sum(axis=1) @ cols) / total_safe
    non_zero = (flat > 0).sum(axis=1)
    return {
        "max_x": max_x.astype(np.float32),
        "max_y": max_y.astype(np.float32),
        "center_x": center_x.astype(np.float32),
        "center_y": center_y.astype(np.float32),
        "non_zero_pixels": non_zero.astype(np.int64),
    }
