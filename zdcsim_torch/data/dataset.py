"""Dataset ingestion and the train/test split (counterpart of
``zdcsim/data/dataset.py``), for the synthetic dataset.

numpy end to end. :func:`get_train_test_data` makes the same draws from
``np.random.default_rng(train.seed)`` in the same order as the JAX package
(the stratified subsample, one permutation per condition group for the
pairing, then the split's permutation), so the split is bit-equal to JAX's.
Reading the reference's pickles, saving the experiment data and resuming
from a saved split are not ported: they come with training (ROADMAP.md,
"the rest of the port": training) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from zdcsim_torch.data.prep import COND_COLUMNS, PreparedDataset, pair_same_condition
from zdcsim_torch.data.scalers import MinMaxScaler, StandardScaler

_TRAINING = "comes with training (ROADMAP.md)"


@dataclass
class SplitArrays:
    """Train/test arrays plus fitted scalers.

    Images are log1p-space ``[N, H, W]``; ``y`` the standardized 9-dim
    conditioning; ``std`` the MinMax-scaled diversity target ``[N, 1]``;
    ``intensity`` the linear photon sum ``[N, 1]``; ``positions`` the
    unscaled (max_x, max_y) ``[N, 2]``.
    """

    x_train: np.ndarray
    x_test: np.ndarray
    x_train_2: np.ndarray  # same-condition paired images
    x_test_2: np.ndarray
    y_train: np.ndarray
    y_test: np.ndarray
    std_train: np.ndarray
    std_test: np.ndarray
    intensity_train: np.ndarray
    intensity_test: np.ndarray
    positions_train: np.ndarray
    positions_test: np.ndarray
    expert_number_train: np.ndarray
    expert_number_test: np.ndarray
    train_indices: np.ndarray
    test_indices: np.ndarray
    scaler_cond: StandardScaler
    scaler_std: MinMaxScaler
    data_cond_names: Tuple[str, ...] = COND_COLUMNS

    @property
    def image_shape(self) -> Tuple[int, int]:
        return tuple(self.x_train.shape[-2:])


def _subset(ds: PreparedDataset, idx: np.ndarray) -> PreparedDataset:
    return PreparedDataset(images=ds.images[idx], cond={k: np.asarray(v)[idx]
                                                        for k, v in ds.cond.items()},
                           positions=ds.positions[idx], zdc_type=ds.zdc_type)


def _stratified_subsample(sums: np.ndarray, n_samples: int, rng: np.random.Generator,
                          n_bins: int = 1000) -> np.ndarray:
    """Uniform-per-quantile-bin subsample of event indices: an equal draw
    from each of ``n_bins`` photon-sum quantile bins, topped up at random to
    ``n_samples``."""
    n = sums.shape[0]
    n_bins = min(n_bins, n)
    order = np.argsort(sums, kind="stable")
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(n)
    bins = ranks * n_bins // n
    per_bin = max(1, n_samples // n_bins)
    selected = []
    for b in np.unique(bins):
        members = np.flatnonzero(bins == b)
        selected.extend(rng.choice(members, size=min(per_bin, members.size), replace=False))
    selected = list(dict.fromkeys(selected))
    if len(selected) < n_samples:
        pool = np.setdiff1d(np.arange(n), np.asarray(selected, dtype=np.int64))
        extra = rng.choice(pool, size=min(n_samples - len(selected), pool.size), replace=False)
        selected.extend(extra)
    return np.asarray(selected[:n_samples], dtype=np.int64)


def get_dataset(cfg, rng: Optional[np.random.Generator] = None) -> PreparedDataset:
    """Synthesize the dataset, keep the events whose photon sum is inside
    ``[MIN_INTENSITY_THRESHOLD, MAX_INTENSITY_THRESHOLD]`` and take the
    stratified subsample of ``read_n_samples`` if it is set."""
    rng = rng or np.random.default_rng(int(cfg.train.seed))
    d = cfg.dataset
    if not d.synthetic:
        raise NotImplementedError(f"reading the reference's pickles {_TRAINING}; "
                                  "set dataset.synthetic=true")
    from zdcsim_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(int(d.synthetic_n_samples), tuple(d.input_image_shape),
                                zdc_type=d.zdc_type, seed=int(cfg.train.seed))
    sums = np.asarray(ds.cond[f"{d.zdc_type}_photon_sum"], np.float64)
    mask = np.ones(sums.shape[0], dtype=bool)
    if d.MIN_INTENSITY_THRESHOLD is not None:
        mask &= sums >= d.MIN_INTENSITY_THRESHOLD
    if d.MAX_INTENSITY_THRESHOLD is not None:
        mask &= sums <= d.MAX_INTENSITY_THRESHOLD
    if not mask.all():
        ds, sums = _subset(ds, mask), sums[mask]
    if d.read_n_samples is not None and d.read_n_samples < sums.shape[0]:
        ds = _subset(ds, _stratified_subsample(sums, int(d.read_n_samples), rng))
    return ds


def transform_data_for_training(cfg, ds: PreparedDataset,
                                rng: Optional[np.random.Generator] = None) -> SplitArrays:
    """Pairing, scaling and the train/test split."""
    rng = rng or np.random.default_rng(int(cfg.train.seed))
    if cfg.train.save_experiment_data:
        raise NotImplementedError(f"train.save_experiment_data {_TRAINING}")
    if cfg.train.checkpoint_experiment_dir is not None and cfg.train.epoch_to_load is not None:
        raise NotImplementedError(f"resuming from a saved split {_TRAINING}")
    zdc = cfg.dataset.zdc_type
    std_col = "std_proton" if zdc == "proton" else "std"
    group_col = "group_number_proton" if zdc == "proton" else "group_number"

    images = ds.images.astype(np.float32)
    n = images.shape[0]
    group_ids = np.asarray(ds.cond.get(group_col, np.arange(n, dtype=np.int64)), np.int64)
    # draws one permutation per condition group before the split's permutation
    images_2 = images[pair_same_condition(group_ids, rng)]

    scaler_std = MinMaxScaler()
    std = scaler_std.fit_transform(np.asarray(ds.cond[std_col], np.float32).reshape(-1, 1))
    intensity = np.asarray(ds.cond[f"{zdc}_photon_sum"], np.float32).reshape(-1, 1)
    expert_number = np.asarray(ds.cond.get("expert_number", np.zeros(n)), np.int64)
    scaler_cond = StandardScaler()
    cond = scaler_cond.fit_transform(ds.cond_matrix())
    positions = ds.positions.astype(np.float32)  # deliberately unscaled

    indices = rng.permutation(n) if cfg.dataset.shuffle_train_test_split else np.arange(n)
    n_test = int(round(n * float(cfg.dataset.test_size)))
    test_idx, train_idx = indices[:n_test], indices[n_test:]

    def sel(a):
        return a[train_idx], a[test_idx]

    x_train, x_test = sel(images)
    x2_train, x2_test = sel(images_2)
    y_train, y_test = sel(cond)
    std_train, std_test = sel(std)
    int_train, int_test = sel(intensity)
    pos_train, pos_test = sel(positions)
    exp_train, exp_test = sel(expert_number)
    return SplitArrays(
        x_train=x_train, x_test=x_test, x_train_2=x2_train, x_test_2=x2_test,
        y_train=y_train, y_test=y_test, std_train=std_train, std_test=std_test,
        intensity_train=int_train, intensity_test=int_test,
        positions_train=pos_train, positions_test=pos_test,
        expert_number_train=exp_train, expert_number_test=exp_test,
        train_indices=np.asarray(train_idx), test_indices=np.asarray(test_idx),
        scaler_cond=scaler_cond, scaler_std=scaler_std,
    )


def get_train_test_data(cfg) -> SplitArrays:
    """Ingest, filter, transform and split, all from one
    ``default_rng(train.seed)`` (the synthetic events take their own)."""
    rng = np.random.default_rng(int(cfg.train.seed))
    return transform_data_for_training(cfg, get_dataset(cfg, rng), rng)
