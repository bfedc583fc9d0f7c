"""The dataset analysis report (the port's own copy of
``zdcsim/evals/report.py``, numpy; its text is byte-equal to JAX's).

The reference's notebooks write a text report of the coordinate
distribution and the intensity-coordinate correlations of a prepared
dataset; :func:`dataset_analysis_report` writes the same from linear-space
shower images: the filter's summary, photon-sum quartiles, per-coordinate
statistics and the correlations. ``python -m zdcsim_torch.data.prep ...
--report`` writes it as ``analysis_report.txt`` beside the prepared pickles.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from zdcsim_torch.evals.stats import image_feature_stats


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.std() == 0 or b.std() == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def dataset_analysis_report(
    images_linear: np.ndarray,
    photon_sums: Optional[np.ndarray] = None,
    n_before_filter: Optional[int] = None,
    title: str = "zdcsim dataset analysis",
) -> str:
    """Text report over linear-space shower images ``[N, H, W]``: the
    max-pixel and centre-of-mass coordinates' min / max / mean / median /
    std, photon-sum quartiles, non-zero pixels, and the correlations of the
    mean intensity and the photon sum with the max pixel's coordinates."""
    images_linear = np.asarray(images_linear)
    n, h, w = images_linear.shape
    stats = image_feature_stats(images_linear)
    if photon_sums is None:
        photon_sums = images_linear.reshape(n, -1).sum(axis=1)
    photon_sums = np.asarray(photon_sums, np.float64)
    mean_int = images_linear.reshape(n, -1).mean(axis=1)

    out = io.StringIO()

    def p(*a):
        print(*a, file=out)

    p(f"=== {title} ===")
    p()
    p("=== Coordinate Distribution Analysis ===")
    if n_before_filter is not None and n_before_filter != n:
        p(f"Reducing the data from: {n_before_filter} to {n} samples")
    p(f"Image geometry: {h}x{w}; events: {n}")
    p("Statistical summary:")
    p(f"{'':8s}{'min':>8s}{'max':>8s}{'mean':>12s}{'median':>9s}{'std':>12s}")
    for key in ("max_x", "max_y", "center_x", "center_y"):
        v = np.asarray(stats[key], np.float64)
        p(f"{key:8s}{v.min():8.1f}{v.max():8.1f}{v.mean():12.6f}"
          f"{np.median(v):9.1f}{v.std(ddof=1):12.6f}")
    p()
    p("=== Photon-Sum Analysis ===")
    qs = np.percentile(photon_sums, [0, 25, 50, 75, 100])
    p(f"quartiles: min {qs[0]:.1f} | q1 {qs[1]:.1f} | median {qs[2]:.1f} | "
      f"q3 {qs[3]:.1f} | max {qs[4]:.1f}")
    p(f"mean {photon_sums.mean():.1f}  std {photon_sums.std(ddof=1):.1f}")
    nz = np.asarray(stats["non_zero_pixels"], np.float64)
    p(f"non-zero pixels per shower: mean {nz.mean():.1f}  median {np.median(nz):.0f}")
    p()
    p("=== Image-Coordinate Relationship Analysis ===")
    p(f"Correlation between mean image intensity and max_x: {_corr(mean_int, stats['max_x']):.3f}")
    p(f"Correlation between mean image intensity and max_y: {_corr(mean_int, stats['max_y']):.3f}")
    p(f"Correlation between photon sum and max_x: {_corr(photon_sums, stats['max_x']):.3f}")
    p(f"Correlation between photon sum and max_y: {_corr(photon_sums, stats['max_y']):.3f}")
    p()
    p("=== Analysis Complete ===")
    return out.getvalue()
