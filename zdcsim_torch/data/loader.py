"""Device-resident batches (counterpart of ``zdcsim/data/loader.py``).

Every array of the split goes to the device once; a batch is an on-device
``index_select``. Each epoch's order comes from numpy
``default_rng((seed, epoch))``, index for index the JAX loader's, and the
remainder batch is dropped.

With a ``mesh`` (the train loader of a run on a ``(data, expert)`` mesh,
JAX's ``sharding=batch_sharding(mesh)``, ``zdcsim/data/loader.py:45-80``)
every rank holds the whole split, takes the same epoch order and yields
its data rank's rows of each global batch (``batch_sharding``'s block).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

BatchDict = Dict[str, torch.Tensor]


class DeviceLoader:
    """Batches over a dict of equal-length arrays held on ``device`` (CUDA
    unless the caller asks for the CPU). ``shuffle=False`` iterates in
    storage order; ``stratify_labels`` orders each shuffled epoch by
    :func:`stratified_batch_order`."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, shuffle: bool = True,
                 seed: int = 0, stratify_labels: Optional[np.ndarray] = None,
                 device: str | torch.device | None = None, mesh=None):
        from zdcsim_torch.device import default_device

        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Array length mismatch: {lengths}")
        self.n = next(iter(lengths.values()))
        self.batch_size = int(batch_size)
        if self.n < self.batch_size:
            raise ValueError(f"batch_size {batch_size} exceeds dataset size {self.n}")
        self.shuffle, self.seed = shuffle, seed
        self.stratify_labels = None if stratify_labels is None else np.asarray(stratify_labels)
        self.n_batches = self.n // self.batch_size
        self.device = default_device(device) if mesh is None else mesh.device
        # the rows of a global batch this rank yields: [lo, hi)
        self.rows = (0, self.batch_size)
        if mesh is not None:
            n_data, d = mesh.shape["data"], mesh.coords[0]
            if self.batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} must be divisible by the 'data' mesh "
                                 f"axis size {n_data}")
            per = self.batch_size // n_data
            self.rows = (d * per, (d + 1) * per)
        self.arrays = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                       for k, v in arrays.items()}

    def order(self, epoch_idx: int = 0) -> np.ndarray:
        """The epoch's sample order (deterministic in ``epoch_idx``)."""
        if not self.shuffle:
            return np.arange(self.n)
        rng = np.random.default_rng((self.seed, epoch_idx))
        if self.stratify_labels is not None:
            return stratified_batch_order(self.stratify_labels, self.batch_size, rng)
        return rng.permutation(self.n)

    def epoch(self, epoch_idx: int = 0) -> Iterator[BatchDict]:
        """The batches of one epoch."""
        order = torch.as_tensor(self.order(epoch_idx)).to(self.device)
        lo, hi = self.rows
        for b in range(self.n_batches):
            idx = order[b * self.batch_size + lo:b * self.batch_size + hi]
            yield {k: v.index_select(0, idx) for k, v in self.arrays.items()}

    def __len__(self) -> int:
        return self.n_batches


def stratified_batch_order(labels: np.ndarray, batch_size: int,
                           rng: np.random.Generator) -> np.ndarray:
    """An epoch's order in which every batch approximates the global label
    mix: shuffle within each class, then interleave the classes
    proportionally (``zdcsim/data/loader.py:87``)."""
    labels = np.asarray(labels).ravel()
    keys = np.empty(labels.shape[0], dtype=np.float64)
    for c in np.unique(labels):
        members = rng.permutation(np.flatnonzero(labels == c))
        keys[members] = (np.arange(members.size) + rng.random(members.size)) / members.size
    return np.argsort(keys, kind="stable")


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



def make_loaders(cfg, split, device: str | torch.device | None = None, mesh=None
                 ) -> Tuple[DeviceLoader, DeviceLoader]:
    """The train and test loaders of a ``SplitArrays`` (``make_loaders``,
    ``zdcsim/data/loader.py:131``): the train side shuffled from
    ``train.seed``, ordered by the expert labels when
    ``train.stratified_batches``, each batch cut to the rank's rows on a
    ``mesh``; the test side whole, in storage order (the evaluator reads its
    arrays)."""
    bs, seed = int(cfg.train.batch_size), int(cfg.train.seed)
    stratify = split.expert_number_train if bool(cfg.train.stratified_batches) else None
    train = DeviceLoader(split_to_arrays(split, True), bs, shuffle=True, seed=seed,
                         stratify_labels=stratify, device=device, mesh=mesh)
    test = DeviceLoader(split_to_arrays(split, False), min(bs, split.x_test.shape[0]),
                        shuffle=False, seed=seed, device=device if mesh is None else mesh.device)
    return train, test
