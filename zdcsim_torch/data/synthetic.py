"""Synthetic GEANT4-like ZDC events (counterpart of ``zdcsim/data/synthetic.py``).

The real GEANT4 pickles are not shipped. This generator makes a stand-in
with the pipeline's schema: kinematics in groups of identical conditions,
showers whose position, width and amplitude follow the kinematics, and
Poisson photon counts. It makes the same ``np.random.default_rng(seed)``
draws, in the same order, as the JAX package, so both give the same events.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from zdcsim_torch.data.prep import PreparedDataset, prepare_dataset


def _sample_kinematics(rng: np.random.Generator, n_unique: int, zdc_type: str) -> Dict[str, np.ndarray]:
    energy = rng.lognormal(mean=5.0, sigma=0.8, size=n_unique).astype(np.float32)
    vx = rng.normal(0.0, 0.05, n_unique).astype(np.float32)
    vy = rng.normal(0.0, 0.05, n_unique).astype(np.float32)
    vz = rng.normal(0.0, 2.0, n_unique).astype(np.float32)
    # longitudinal momentum dominates; small transverse kick
    pz = (energy * rng.uniform(0.9, 1.0, n_unique)).astype(np.float32)
    px = rng.normal(0.0, 0.3, n_unique).astype(np.float32)
    py = rng.normal(0.0, 0.3, n_unique).astype(np.float32)
    if zdc_type == "proton":
        mass = np.full(n_unique, 0.938272, np.float32)
        charge = np.ones(n_unique, np.float32)
    else:
        mass = np.full(n_unique, 0.939565, np.float32)
        charge = np.zeros(n_unique, np.float32)
    return {
        "Energy": energy, "Vx": vx, "Vy": vy, "Vz": vz,
        "Px": px, "Py": py, "Pz": pz, "mass": mass, "charge": charge,
    }


def _render_showers(
    rng: np.random.Generator, cond: Dict[str, np.ndarray], shape: Tuple[int, int]
) -> np.ndarray:
    """Linear-space showers ``[N, H, W]``: a Gaussian spot whose centre
    follows px/py (and vx/vy), whose width grows with log energy and whose
    amplitude is 2x the energy, with Poisson counts per pixel."""
    h, w = shape
    n = cond["Energy"].shape[0]
    e = cond["Energy"]
    cx = (h / 2.0) + cond["Px"] * (h / 4.0) + cond["Vx"] * 5.0
    cy = (w / 2.0) + cond["Py"] * (w / 4.0) + cond["Vy"] * 5.0
    cx = np.clip(cx, 2.0, h - 3.0)
    cy = np.clip(cy, 2.0, w - 3.0)
    sigma = 1.5 + 0.4 * np.log1p(e)
    amp = e * 2.0

    rows = np.arange(h, dtype=np.float32)[None, :, None]
    cols = np.arange(w, dtype=np.float32)[None, None, :]
    d2 = (rows - cx[:, None, None]) ** 2 + (cols - cy[:, None, None]) ** 2
    mean = amp[:, None, None] * np.exp(-d2 / (2.0 * sigma[:, None, None] ** 2))
    return rng.poisson(mean).astype(np.float32).reshape(n, h, w)


def make_synthetic_dataset(
    n_samples: int,
    shape: Tuple[int, int],
    zdc_type: str = "proton",
    seed: int = 0,
    group_size: int = 4,
) -> PreparedDataset:
    """A prepared synthetic dataset of ``n_samples`` events; ``group_size``
    events share each conditioning vector."""
    rng = np.random.default_rng(seed)
    n_unique = max(1, n_samples // group_size)
    uniq = _sample_kinematics(rng, n_unique, zdc_type)
    reps = np.full(n_unique, group_size)
    short = n_samples - int(reps.sum())
    if short > 0:
        reps[:short] += 1
    elif short < 0:
        reps[short:] -= 1
    cond = {k: np.repeat(v, reps)[:n_samples] for k, v in uniq.items()}
    images = _render_showers(rng, cond, shape)
    return prepare_dataset(images, cond, zdc_type)
