"""The batch arrays of a split (counterpart of ``split_to_arrays`` in
``zdcsim/data/loader.py``). The device loader comes with training."""

from __future__ import annotations

from typing import Dict

import numpy as np


def split_to_arrays(split, train: bool) -> Dict[str, np.ndarray]:
    """``SplitArrays`` -> the numpy batch dict of the train or test side;
    ``real`` is NHWC ``[N, H, W, 1]``. The paired image is left out, as in
    the JAX package: no step reads it."""
    s = "train" if train else "test"

    def g(name):
        return getattr(split, f"{name}_{s}")

    return {
        "real": g("x")[..., None],
        "cond": g("y"),
        "std": g("std"),
        "intensity": g("intensity"),
        "positions": g("positions"),
    }
