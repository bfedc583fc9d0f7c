"""Data preparation of raw events (counterpart of ``zdcsim/data/prep.py``):
photon sums, the log1p transform, the photon-sum filter, argmax
coordinates, condition groups, the SDI-GAN diversity target and
same-condition pairing.

Photon sums, argmax coordinates and the diversity target's group
standard deviation run on the port's host C++ library
(``zdcsim_torch.native``, built with the host's g++ at first use) where
the JAX package runs its own (``zdcsim/native``); where it cannot be built,
a warning is logged once and the numpy versions run instead, as in JAX.
Host code, off the card's path. The two agree exactly on photon sums of
photon counts and on coordinates, and within 1e-5 on the diversity target
(Welford in C++, two-pass float64 in numpy), which no split or test
membership reads.

The command line, ``python -m zdcsim_torch.data.prep`` (JAX's flags), reads
the raw images and the raw conditioning through
:mod:`zdcsim_torch.data.pickles` (no pandas), prepares them and writes the
three training pickles with :func:`save_prepared`, which needs pandas (the
reference's on-disk layout is pandas' own) and raises without it;
``--report`` writes ``analysis_report.txt`` beside them
(``zdcsim_torch.evals.report``).
"""

from __future__ import annotations

import argparse
import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from zdcsim_torch import native

log = logging.getLogger(__name__)

COND_COLUMNS = ("Energy", "Vx", "Vy", "Vz", "Px", "Py", "Pz", "mass", "charge")


def photon_sums(images_linear: np.ndarray) -> np.ndarray:
    """Per-event photon sum of linear-space images ``[N, H, W]``: ``[N]`` float32."""
    return native.photon_sums(np.asarray(images_linear, np.float32))


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
    return native.max_coords(np.asarray(images, np.float32).reshape(n, h, w))


def group_by_condition(cond: np.ndarray) -> np.ndarray:
    """Group id per event: events with bit-identical conditioning rows share
    one (a lexicographic unique over the float64 rows)."""
    _, group_ids = np.unique(np.ascontiguousarray(np.asarray(cond, np.float64)), axis=0,
                             return_inverse=True)
    return group_ids.astype(np.int64).reshape(-1)


def _group_pixel_std(images: np.ndarray, group_ids: np.ndarray) -> np.ndarray:
    """Per event, its group's per-pixel std summed over pixels; groups of
    one get 0."""
    return native.group_pixel_std(np.asarray(images, np.float32), group_ids)


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


def save_prepared(ds: PreparedDataset, images_path: str, cond_path: str,
                  positions_path: str) -> None:
    """Write the three training pickles in the reference's layout: the
    images as a pickled ndarray, the conditioning and the (max_x, max_y)
    positions as pickled DataFrames. Needs pandas; raises ``ImportError``
    without it and writes nothing."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("save_prepared needs pandas: the training pickles are pandas "
                          "DataFrames (pd.to_pickle), and this host has no pandas") from e
    pd.to_pickle(ds.images, images_path)
    pd.to_pickle(pd.DataFrame(ds.cond), cond_path)
    pd.to_pickle(pd.DataFrame({"max_x": ds.positions[:, 0], "max_y": ds.positions[:, 1]}),
                 positions_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="zdcsim_torch offline data prep")
    parser.add_argument("--raw-images", required=True, help="pickle of linear-space [N,H,W] images")
    parser.add_argument("--raw-cond", required=True, help="pickle of conditioning DataFrame")
    parser.add_argument("--zdc-type", choices=("proton", "neutron"), required=True)
    parser.add_argument("--min-photon-sum", type=float, default=None)
    parser.add_argument("--max-photon-sum", type=float, default=None)
    parser.add_argument("--out-images", required=True)
    parser.add_argument("--out-cond", required=True)
    parser.add_argument("--out-positions", required=True)
    parser.add_argument(
        "--report", action="store_true",
        help="write analysis_report.txt (coordinate, photon-sum and correlation analyses) "
             "next to --out-images")
    args = parser.parse_args(argv)

    from zdcsim_torch.data.pickles import read_pickle

    raw_images = np.asarray(read_pickle(args.raw_images))
    raw_cond = read_pickle(args.raw_cond)
    cond = {c: np.asarray(raw_cond[c]) for c in COND_COLUMNS}
    ds = prepare_dataset(raw_images, cond, args.zdc_type, args.min_photon_sum,
                         args.max_photon_sum)
    save_prepared(ds, args.out_images, args.out_cond, args.out_positions)
    if args.report:
        from zdcsim_torch.evals.report import dataset_analysis_report

        text = dataset_analysis_report(
            np.expm1(ds.images),
            photon_sums=np.asarray(ds.cond[f"{args.zdc_type}_photon_sum"]),
            n_before_filter=raw_images.shape[0],
            title=f"zdcsim {args.zdc_type} dataset analysis",
        )
        path = os.path.join(os.path.dirname(os.path.abspath(args.out_images)),
                            "analysis_report.txt")
        with open(path, "w") as f:
            f.write(text)
        log.info("Analysis report written to %s", path)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
