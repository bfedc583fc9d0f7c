"""Dataset ingestion and the train/test split (counterpart of
``zdcsim/data/dataset.py``).

numpy end to end. The reference's three training pickles are read by
:mod:`zdcsim_torch.data.pickles` (no pandas: the GPU machine has none);
``dataset.synthetic=true`` makes synthetic events in their place.
:func:`get_train_test_data` makes the same draws from
``np.random.default_rng(train.seed)`` in the same order as the JAX package
(the stratified subsample, one permutation per condition group for the
pairing, then the split's permutation), so the split is bit-equal to JAX's.
:func:`get_dataset` stamps the kept events' photon-sum range on the config
as ``cfg.photon_sum_min`` / ``cfg.photon_sum_max``, and
:func:`transform_data_for_training` the condition names as
``cfg.data_cond_names``, as JAX does.
``train.save_experiment_data`` writes the scales and the split indices into
the run's directory (``zdcsim_torch.utils.io``, the JAX package's formats),
and a resume (``train.checkpoint_experiment_dir`` with
``train.epoch_to_load``) reads the saved indices back.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from zdcsim_torch.data.prep import COND_COLUMNS, PreparedDataset, pair_same_condition
from zdcsim_torch.data.scalers import MinMaxScaler, StandardScaler
from zdcsim_torch.utils.io import (
    DIR_INFO, DIR_MODELS, create_dir, load_train_test_indices, save_scales,
    save_train_test_indices,
)

log = logging.getLogger(__name__)


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
    # the run's checkpoint directory; set only with train.save_experiment_data,
    # so without it the checkpoint callback writes nothing (as in JAX)
    dir_models: Optional[str] = None

    @property
    def image_shape(self) -> Tuple[int, int]:
        return tuple(self.x_train.shape[-2:])


def _subset(ds: PreparedDataset, idx: np.ndarray) -> PreparedDataset:
    return PreparedDataset(images=ds.images[idx], cond={k: np.asarray(v)[idx]
                                                        for k, v in ds.cond.items()},
                           positions=ds.positions[idx], zdc_type=ds.zdc_type)


def _load_pickles(cfg) -> PreparedDataset:
    """Read the three reference-format training pickles into a
    PreparedDataset: the images as float32, the conditioning columns as
    stored, the (max_x, max_y) positions as float32; the top-level
    ``limit_samples`` keeps the first rows of all three."""
    from zdcsim_torch.data.pickles import read_pickle

    d, limit = cfg.dataset, cfg.limit_samples
    data = np.asarray(read_pickle(d.DATA_IMAGES_PATH), np.float32)
    cond = read_pickle(d.DATA_COND_PATH)
    posi = read_pickle(d.DATA_POSITIONS_PATH)
    if limit is not None:
        data = data[:limit]
        cond = {k: v[:limit] for k, v in cond.items()}
        posi = {k: v[:limit] for k, v in posi.items()}
    positions = np.stack([np.asarray(posi["max_x"], np.float32),
                          np.asarray(posi["max_y"], np.float32)], axis=1)
    return PreparedDataset(images=data, cond=cond, positions=positions, zdc_type=d.zdc_type)


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
    """Read the pickles (or synthesize the events), keep the events whose
    photon sum is inside ``[MIN_INTENSITY_THRESHOLD,
    MAX_INTENSITY_THRESHOLD]``, take the stratified subsample of
    ``read_n_samples`` if it is set, and stamp the kept photon-sum range as
    ``cfg.photon_sum_min`` / ``cfg.photon_sum_max``."""
    rng = rng or np.random.default_rng(int(cfg.train.seed))
    d = cfg.dataset
    if d.synthetic:
        from zdcsim_torch.data.synthetic import make_synthetic_dataset

        ds = make_synthetic_dataset(int(d.synthetic_n_samples), tuple(d.input_image_shape),
                                    zdc_type=d.zdc_type, seed=int(cfg.train.seed))
    else:
        ds = _load_pickles(cfg)
    sums = np.asarray(ds.cond[f"{d.zdc_type}_photon_sum"], np.float64)
    mask = np.ones(sums.shape[0], dtype=bool)
    if d.MIN_INTENSITY_THRESHOLD is not None:
        mask &= sums >= d.MIN_INTENSITY_THRESHOLD
    if d.MAX_INTENSITY_THRESHOLD is not None:
        mask &= sums <= d.MAX_INTENSITY_THRESHOLD
    if not mask.all():
        ds, sums = _subset(ds, mask), sums[mask]
    if d.read_n_samples is not None and d.read_n_samples < sums.shape[0]:
        idx = _stratified_subsample(sums, int(d.read_n_samples), rng)
        ds, sums = _subset(ds, idx), sums[idx]
    cfg.photon_sum_min = float(sums.min())
    cfg.photon_sum_max = float(sums.max())
    log.info("Dataset: %d events, photon sum in [%.1f, %.1f]",
             ds.n_events, cfg.photon_sum_min, cfg.photon_sum_max)
    return ds


def transform_data_for_training(cfg, ds: PreparedDataset,
                                rng: Optional[np.random.Generator] = None) -> SplitArrays:
    """Pairing, scaling and the train/test split. On resume the split
    indices saved in ``train.checkpoint_experiment_dir`` are read back, so
    train/test membership is the saved run's; with
    ``train.save_experiment_data`` the scales and the indices are written
    into this run's ``info/`` directory, on resume too."""
    rng = rng or np.random.default_rng(int(cfg.train.seed))
    experiment_dir = cfg.config.experiment_dir or cfg.config.run_name
    dir_info = DIR_INFO.format(EXPERIMENT_DIR_NAME=experiment_dir)
    dir_models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=experiment_dir)
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

    if cfg.train.checkpoint_experiment_dir is not None and cfg.train.epoch_to_load is not None:
        ckpt_info = DIR_INFO.format(EXPERIMENT_DIR_NAME=cfg.train.checkpoint_experiment_dir)
        train_idx, test_idx = load_train_test_indices(ckpt_info)
    else:
        indices = rng.permutation(n) if cfg.dataset.shuffle_train_test_split else np.arange(n)
        n_test = int(round(n * float(cfg.dataset.test_size)))
        test_idx, train_idx = indices[:n_test], indices[n_test:]
    if cfg.train.save_experiment_data:
        create_dir(dir_info)
        save_scales(zdc, scaler_cond.mean_, scaler_cond.scale_, dir_info)
        create_dir(dir_models)
        save_train_test_indices(dir_info, train_indices=train_idx, test_indices=test_idx)

    def sel(a):
        return a[train_idx], a[test_idx]

    x_train, x_test = sel(images)
    x2_train, x2_test = sel(images_2)
    y_train, y_test = sel(cond)
    std_train, std_test = sel(std)
    int_train, int_test = sel(intensity)
    pos_train, pos_test = sel(positions)
    exp_train, exp_test = sel(expert_number)
    cfg.data_cond_names = list(COND_COLUMNS)
    log.info("Split: %d train / %d test", x_train.shape[0], x_test.shape[0])
    return SplitArrays(
        x_train=x_train, x_test=x_test, x_train_2=x2_train, x_test_2=x2_test,
        y_train=y_train, y_test=y_test, std_train=std_train, std_test=std_test,
        intensity_train=int_train, intensity_test=int_test,
        positions_train=pos_train, positions_test=pos_test,
        expert_number_train=exp_train, expert_number_test=exp_test,
        train_indices=np.asarray(train_idx), test_indices=np.asarray(test_idx),
        scaler_cond=scaler_cond, scaler_std=scaler_std,
        dir_models=dir_models if cfg.train.save_experiment_data else None,
    )


def get_train_test_data(cfg) -> SplitArrays:
    """Ingest, filter, transform and split, all from one
    ``default_rng(train.seed)`` (the synthetic events take their own)."""
    rng = np.random.default_rng(int(cfg.train.seed))
    return transform_data_for_training(cfg, get_dataset(cfg, rng), rng)
