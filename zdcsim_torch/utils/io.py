"""Experiment IO: run directories, scaler persistence, split indices (the
port's own copy of ``zdcsim/utils/io.py``, numpy and the standard library
only).

The on-disk formats are the JAX package's, which are the reference's: the
scales as text, the split indices as ``train_test_indices.npz``, so a run
of either package can resume from the other's saved split.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Tuple

import numpy as np

DIR_INFO = "{EXPERIMENT_DIR_NAME}/info/"
DIR_MODELS = "{EXPERIMENT_DIR_NAME}/models/"
TRAIN_TEST_INDICES_FILENAME = "train_test_indices.npz"


def create_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def save_scales(model_name: str, scaler_means, scaler_scales, dirpath: str) -> str:
    """Write a ``StandardScaler``'s means and scales as text
    (``<model_name>_scales.txt``: ``#means``, one value a line, a blank
    line, ``#scales``, one value a line)."""
    out = os.path.join(dirpath, f"{model_name}_scales.txt")
    lines = ["#means"] + [str(m) for m in np.asarray(scaler_means).ravel()]
    lines += ["", "#scales"] + [str(s) for s in np.asarray(scaler_scales).ravel()]
    create_dir(dirpath)
    with open(out, "w") as f:
        f.write("\n".join(lines))
    return out


def load_scales(model_name: str, dirpath: str) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`save_scales`, as float32."""
    path = os.path.join(dirpath, f"{model_name}_scales.txt")
    means, scales, target = [], [], None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line == "#means":
                target = means
            elif line == "#scales":
                target = scales
            elif line and target is not None:
                target.append(float(line))
    return np.array(means, np.float32), np.array(scales, np.float32)


def save_train_test_indices(dirpath: str, train_indices, test_indices) -> str:
    create_dir(dirpath)
    path = os.path.join(dirpath, TRAIN_TEST_INDICES_FILENAME)
    np.savez(path, train_indices=np.asarray(train_indices), test_indices=np.asarray(test_indices))
    return path


def load_train_test_indices(dirpath: str) -> Tuple[np.ndarray, np.ndarray]:
    path = os.path.join(dirpath, TRAIN_TEST_INDICES_FILENAME)
    data = np.load(path)
    return data["train_indices"], data["test_indices"]


def append_experiment_dir_to_cfg(cfg) -> None:
    """Stamp a timestamped run name on ``cfg.wandb.run_name`` and the
    experiment directory on ``cfg.config.experiment_dir``
    (``<train.save_experiments_dir>/<run_name>_<date>``, or the run name
    alone where that is ``None``)."""
    date_str = datetime.now().strftime("%d_%m_%Y_%H_%M_%S_%f")
    run_name_with_date = f"{cfg.config.run_name}_{date_str}"
    cfg.config.date = date_str
    cfg.wandb.run_name = run_name_with_date
    if cfg.train.save_experiments_dir is None:
        cfg.config.experiment_dir = run_name_with_date
    else:
        cfg.config.experiment_dir = os.path.join(cfg.train.save_experiments_dir, run_name_with_date)
