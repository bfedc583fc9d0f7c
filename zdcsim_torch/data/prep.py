"""Data preparation of raw events (counterpart of ``zdcsim/data/prep.py``):
photon sums, the log1p transform, the photon-sum filter, argmax
coordinates, condition groups, the SDI-GAN diversity target and
same-condition pairing.

numpy only. Where the JAX package calls its host C++ library
(``zdcsim/native``) it falls back to numpy; this module has those numpy
versions alone. They agree with the C++ ones exactly on photon sums and
coordinates, and within 1e-5 on the diversity target (Welford in C++,
two-pass float64 here), which no split or test membership reads. The
pickle writer and the command line of the JAX module are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

COND_COLUMNS = ("Energy", "Vx", "Vy", "Vz", "Px", "Py", "Pz", "mass", "charge")


def photon_sums(images_linear: np.ndarray) -> np.ndarray:
    """Per-event photon sum of linear-space images ``[N, H, W]``: ``[N]`` float32."""
    images = np.ascontiguousarray(images_linear, np.float32)
    return images.reshape(images.shape[0], -1).sum(axis=1)


def log_transform(images_linear: np.ndarray) -> np.ndarray:
    """Linear photon counts -> log1p space (the training representation)."""
    return np.log1p(images_linear.astype(np.float32))


def filter_photon_sum(sums: np.ndarray, min_sum: Optional[float] = None,
                      max_sum: Optional[float] = None) -> np.ndarray:
    """Boolean mask of the events with a photon sum in ``[min_sum, max_sum]``
    (inclusive; ``None`` leaves that side open)."""
    mask = np.ones(sums.shape[0], dtype=bool)
    if min_sum is not None:
        mask &= sums >= min_sum
    if max_sum is not None:
        mask &= sums <= max_sum
    return mask


def max_coordinates(images: np.ndarray) -> np.ndarray:
    """Argmax pixel (row, col) of each image as ``[N, 2]`` float32; the first
    maximum in row-major order wins a tie."""
    n, h, w = images.shape[0], images.shape[-2], images.shape[-1]
    flat = np.asarray(images, np.float32).reshape(n, h * w).argmax(axis=1)
    return np.stack([flat // w, flat % w], axis=1).astype(np.float32)


def group_by_condition(cond: np.ndarray) -> np.ndarray:
    """Group id per event: events with bit-identical conditioning rows share
    one (a lexicographic unique over the float64 rows)."""
    _, group_ids = np.unique(np.ascontiguousarray(np.asarray(cond, np.float64)), axis=0,
                             return_inverse=True)
    return group_ids.astype(np.int64).reshape(-1)


def _group_pixel_std(images: np.ndarray, group_ids: np.ndarray) -> np.ndarray:
    """Per event, its group's per-pixel std (float64) summed over pixels;
    groups of one get 0."""
    n = images.shape[0]
    order = np.argsort(group_ids, kind="stable")
    sorted_ids = np.asarray(group_ids)[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sorted_ids)) + 1, [n]])
    out = np.zeros(n, np.float64)
    flat = np.asarray(images, np.float32).reshape(n, -1).astype(np.float64)
    for lo, hi in zip(starts[:-1], starts[1:]):
        seg = order[lo:hi]
        if seg.size > 1:
            out[seg] = flat[seg].std(axis=0).sum()
    return out.astype(np.float32)


def diversity_std(images_log: np.ndarray, group_ids: np.ndarray) -> np.ndarray:
    """SDI-GAN diversity target of each event: its group's per-pixel std of
    the LOG-space images, summed over pixels, divided by the dataset's
    maximum (groups of one get 0)."""
    out = _group_pixel_std(images_log, group_ids)
    peak = out.max() if out.size else 0.0
    if peak > 0:
        out = out / peak
    return out.astype(np.float32)


def pair_same_condition(group_ids: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """For each event, the index of a random event of its condition group
    (possibly itself): one ``rng.permutation`` per group, the groups in the
    order of a stable argsort of the ids."""
    n = group_ids.shape[0]
    order = np.argsort(group_ids, kind="stable")
    boundaries = np.flatnonzero(np.diff(group_ids[order])) + 1
    pair = np.empty(n, dtype=np.int64)
    for seg in np.split(order, boundaries):
        pair[seg] = rng.permutation(seg)
    return pair


@dataclass
class PreparedDataset:
    """Training-ready arrays in the reference pickle layout.

    images: ``[N, H, W]`` log1p-space; cond: the 9 kinematic columns plus
    ``{zdc}_photon_sum``, the diversity target and the group ids;
    positions: ``[N, 2]``.
    """

    images: np.ndarray
    cond: Dict[str, np.ndarray]
    positions: np.ndarray
    zdc_type: str

    @property
    def n_events(self) -> int:
        return self.images.shape[0]

    def cond_matrix(self) -> np.ndarray:
        """``[N, 9]`` float32 conditioning in ``COND_COLUMNS`` order."""
        return np.stack([self.cond[c] for c in COND_COLUMNS], axis=1).astype(np.float32)


def prepare_dataset(raw_images: np.ndarray, cond: Dict[str, np.ndarray], zdc_type: str,
                    min_photon_sum: Optional[float] = None,
                    max_photon_sum: Optional[float] = None) -> PreparedDataset:
    """Raw linear-space events -> training arrays: filter by photon sum,
    group, log-transform, diversity target (in log space), coordinates."""
    sums = photon_sums(raw_images)
    mask = filter_photon_sum(sums, min_photon_sum, max_photon_sum)
    raw_images = raw_images[mask]
    sums = sums[mask]
    cond = {k: np.asarray(v)[mask] for k, v in cond.items()}

    group_ids = group_by_condition(np.stack([cond[c] for c in COND_COLUMNS], axis=1))
    images_log = log_transform(raw_images)
    std = diversity_std(images_log, group_ids)
    positions = max_coordinates(raw_images)

    out_cond = dict(cond)
    out_cond[f"{zdc_type}_photon_sum"] = sums.astype(np.float32)
    out_cond["std" if zdc_type == "neutron" else "std_proton"] = std
    out_cond["group_number" if zdc_type == "neutron" else "group_number_proton"] = group_ids
    if zdc_type == "proton":
        # the reference's proton pickles carry an expert label no one reads
        out_cond["expert_number"] = np.zeros(images_log.shape[0], dtype=np.int64)
    return PreparedDataset(images=images_log, cond=out_cond, positions=positions,
                           zdc_type=zdc_type)
