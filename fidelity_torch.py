#!/usr/bin/env python3
"""Physics-fidelity gate of the PyTorch port (counterpart of ``fidelity.py``).

    python3 fidelity_torch.py                          # the teacher artifact, int8, on CUDA
    python3 fidelity_torch.py artifacts/gate/student_w0.125_serving_weights.npz
    python3 fidelity_torch.py artifact int8_pallas     # target, then precision
    python3 fidelity_torch.py artifact int8 --device cpu
    python3 fidelity_torch.py <run_dir> [precision] [--epoch N] [--weights raw|ema]

Serves a committed serving artifact (proton or neutron) on the gate's test
split and prints, on its last line, one JSON object with ``fidelity.py``'s
keys plus ``device``: ``value`` is the matched-N 5-channel W1 of generated
against real showers over the real-vs-real floor of two seeded halves of
the test split, averaged over ``N_DRAWS`` noise draws; ``vs_baseline >=
1.0`` passes (``value <= CRITERION``). A neutron artifact (``family:
neutron``) gates on the neutron dataset and geometry (44x44), and
teacher-relative: a student with ``teacher_x_floor`` passes at ``value <=
NEUTRON_REL_CRITERION * teacher_x_floor``, and the teacher's record is
informational (``vs_baseline: null``), as ``fidelity.py``'s. An earlier
line gives the routing histogram of the gate's conditions.

The path: the artifact -> the test split of the synthetic dataset
(25600 events, seed 7, in numpy) -> the real channel sums on kernel E
(``zdcsim_torch.ops.epilogue_kernels``) -> the floor -> ``N_DRAWS`` serves
through ``FastSim.simulate_bulk`` (noise from ``torch.Generator`` seeded
``100 + d``, so the draws are not JAX's) -> generated channel sums and W1.

A run directory of the port's training checkpoints (``cli_torch.py`` with
``train.save_experiment_data``: ``<run_dir>/models/state_epoch_<n>/``)
gates as ``fidelity.py:110-138, 172-181, 225-234`` gates one: its latest
epoch unless ``--epoch``, the EMA weights unless ``--weights raw``, the
split that the run saved, served by ``FastSim.from_checkpoint``; the record
names ``<run_dir>@<epoch>`` and warns below ``CALIBRATION_EPOCHS``. The
config is the gate's data recipe with the run's resume keys
(``fidelity.py:202-207``) and any ``--override`` (a run of another model
than the default, e.g. ``model.generator.width=0.125``). A directory of
the JAX package's Orbax checkpoints raises a ``FileNotFoundError`` that
names the format: the port reads only its own.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zdcsim_torch.config import NEUTRON_OVERRIDES

CRITERION = 1.5  # pass: matched-N ws_mean <= 1.5x the real-vs-real floor
CALIBRATION_EPOCHS = 150
# neutron students gate relative to their teacher's x-floor (fidelity.py:61)
NEUTRON_REL_CRITERION = 1.10
DEFAULT_RUN_GLOBS = (
    "experiments/fidelity_ckpt_*",
    "experiments/r2_proton_bf16_150ep_*",
)
ARTIFACT_PATH = "artifacts/gate/gate_serving_weights.npz"
N_DRAWS = 3
# the keys of fidelity.py's record (:241-262); a run directory's adds "warning"
# below CALIBRATION_EPOCHS, and the port's adds "device"
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "ws_mean", "ws_mean_rel",
               "ws_real_floor", "criterion_x_floor", "checkpoint", "weights", "precision",
               "n_test")
# the data recipe the gate's weights trained on (fidelity.py:202-206)
GATE_OVERRIDES = (
    "dataset.synthetic=true", "dataset.synthetic_n_samples=25600",
    "train.batch_size=512", "model.n_experts=3", "train.seed=7",
)


def _resolve_default_run() -> Optional[str]:
    for pattern in DEFAULT_RUN_GLOBS:
        runs = [d for d in glob.glob(pattern) if os.path.isdir(d)]
        if runs:
            return max(runs, key=os.path.getmtime)
    return None


def _resolve_target(arg1: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """Map the first argument to ``(artifact_path, experiment_dir)``.

    ``"artifact"`` gates the committed teacher artifact; a ``*.npz`` path
    gates that serving artifact; anything else is a run directory. With no
    argument, the newest on-disk gate run wins, else the committed artifact.
    """
    if arg1 == "artifact":
        return ARTIFACT_PATH, None
    if arg1 is not None and arg1.endswith(".npz"):
        return arg1, None
    exp_dir = arg1 or _resolve_default_run()
    if exp_dir is None and os.path.exists(ARTIFACT_PATH):
        return ARTIFACT_PATH, None
    return None, exp_dir


def _resolve_latest_epoch(exp_dir: str) -> Optional[int]:
    """The highest saved epoch of a run directory (``fidelity.py:124``):
    its ``models/state_epoch_<n>`` directories, or ``None``."""
    from zdcsim_torch.train.checkpoint import latest_epoch
    from zdcsim_torch.utils.io import DIR_MODELS

    return latest_epoch(DIR_MODELS.format(EXPERIMENT_DIR_NAME=exp_dir))


def _artifact_model_config(meta: Dict[str, str]) -> List[str]:
    """Config overrides from an artifact's metadata (``fidelity.py:85-107``):
    a distilled student's ``width``, a ``norm`` and a ``generator_version``;
    ``family="neutron"`` puts the neutron preset first."""
    overrides = [*NEUTRON_OVERRIDES] if meta.get("family") == "neutron" else []
    if "width" in meta:
        overrides.append(f"model.generator.width={float(meta['width'])}")
    if "norm" in meta:
        overrides.append(f"model.norm={meta['norm']}")
    if "generator_version" in meta:
        overrides.append(f"model.generator.version={meta['generator_version']}")
    return overrides


def neutron_criterion(meta: Dict[str, str], ratio: float) -> Dict[str, object]:
    """The neutron family's ``criterion`` and ``vs_baseline``
    (``fidelity.py:269-288``): the family saturates near 5x the floor at
    synthetic scale, so a student holds its teacher's fidelity within
    ``NEUTRON_REL_CRITERION``, and the teacher is informational."""
    if "teacher_x_floor" in meta:
        rel_bar = NEUTRON_REL_CRITERION * float(meta["teacher_x_floor"])
        return {"criterion": f"teacher-relative: <= {NEUTRON_REL_CRITERION}x teacher "
                             f"({rel_bar:.3f}x floor)",
                "vs_baseline": round(rel_bar / max(ratio, 1e-9), 3)}
    return {"vs_baseline": None,
            "criterion": "informational (neutron family saturates ~5x floor at synthetic "
                         "scale; students gate teacher-relative)"}


def gate_split(cfg) -> Tuple[np.ndarray, np.ndarray]:
    """The gate's test side: ``(cond [n, 9], real [n, H, W])`` float32, the
    real showers in log space."""
    from zdcsim_torch.data.dataset import get_train_test_data
    from zdcsim_torch.data.loader import split_to_arrays

    arrays = split_to_arrays(get_train_test_data(cfg), False)
    return arrays["cond"], arrays["real"][..., 0]


def real_floor(ch_real):
    """``(floor, perm)``: the mean per-channel W1 between two halves of the
    real channel sums, split by ``default_rng(0).permutation(n)``."""
    import torch

    from zdcsim_torch.ops.ws import wasserstein_per_channel

    n = ch_real.shape[0]
    perm = torch.as_tensor(np.random.default_rng(0).permutation(n), device=ch_real.device)
    half = n // 2
    ch_perm = ch_real[perm]
    return float(torch.mean(wasserstein_per_channel(ch_perm[:half], ch_perm[half:2 * half]))), perm


def fidelity_record(ch_real, ch_gens: Sequence, meta: Optional[Dict[str, str]] = None
                    ) -> Dict[str, object]:
    """The numbers of the gate from ``[n, 5]`` real channel sums and one
    ``[n, 5]`` generated set per draw (``fidelity.py:224-262``): the full-N
    W1 and the matched-N W1 (the generated sums taken in the floor's
    permutation, second half) averaged over the draws, and their ratio to
    the floor. An artifact's ``meta`` of the neutron family sets the
    neutron ``criterion`` and ``vs_baseline`` (:func:`neutron_criterion`)."""
    import torch

    from zdcsim_torch.ops.ws import wasserstein_per_channel

    floor, perm = real_floor(ch_real)
    half = ch_real.shape[0] // 2
    ch_perm = ch_real[perm]
    scale = float(torch.mean(ch_real))
    ws_full, ws_half = [], []
    for ch_gen in ch_gens:
        ws_full.append(float(torch.mean(wasserstein_per_channel(ch_real, ch_gen))))
        # matched sample size against the floor (W1's finite-sample bias ~ 1/sqrt(N))
        ws_half.append(float(torch.mean(wasserstein_per_channel(
            ch_perm[:half], ch_gen[perm][half:2 * half]))))
    ws_full_m = float(np.mean(ws_full))
    ratio = float(np.mean(ws_half)) / max(floor, 1e-9)
    record = {
        "metric": "fastsim_fidelity",
        "value": round(ratio, 3),
        "unit": "x_floor",
        "vs_baseline": round(CRITERION / max(ratio, 1e-9), 3),
        "ws_mean": round(ws_full_m, 1),
        "ws_mean_rel": round(ws_full_m / max(scale, 1e-9), 4),
        "ws_real_floor": round(floor, 1),
        "criterion_x_floor": CRITERION,
    }
    if meta is not None and meta.get("family") == "neutron":
        record.update(neutron_criterion(meta, ratio))
    return record


def run_gate(target: Optional[str] = None, precision: str = "int8", device=None,
             data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             n_draws: int = N_DRAWS, epoch: Optional[int] = None, weights: str = "ema",
             overrides: Sequence[str] = (), loaded: Optional[Tuple] = None
             ) -> Dict[str, object]:
    """Gate one artifact or run directory; returns the JSON record.

    ``data`` is ``(cond, real)`` as :func:`gate_split` returns it, to gate
    several targets on one split (or on part of it); ``None`` builds it.
    ``epoch`` (latest if ``None``) and ``weights`` (``ema`` or ``raw``)
    choose a run directory's checkpoint; ``overrides`` follow the gate's
    config. ``loaded``: ``(gen_params, gen_stats, router_params, meta)`` as
    ``load_serving_artifact`` returns them, gated in place of a file
    (``target`` then only names it). The engine runs chunks of 2048
    conditions, or one chunk of fewer.
    """
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.device import default_device
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.ops.channels import sum_channels
    from zdcsim_torch.ops.epilogue_kernels import expm1_channel_sums
    from zdcsim_torch.utils.artifact import load_serving_artifact
    from zdcsim_torch.utils.io import DIR_MODELS

    if weights not in ("ema", "raw"):
        raise ValueError(f"weights must be ema|raw, got {weights!r}")
    art_path, exp_dir = (target, None) if loaded is not None else _resolve_target(target)
    if art_path is None and exp_dir is None:
        raise FileNotFoundError(f"no gate run directory and no artifact at {ARTIFACT_PATH}")
    dev = default_device(device)
    if exp_dir is not None:
        epoch = _resolve_latest_epoch(exp_dir) if epoch is None else int(epoch)
        if epoch is None:
            raise FileNotFoundError(f"no state_epoch_* checkpoints under {exp_dir}")
        meta = {"epoch": str(epoch), "weights": weights}
        cfg = load_config([*GATE_OVERRIDES, f"train.checkpoint_experiment_dir={exp_dir}",
                           f"train.epoch_to_load={epoch}", *overrides])
        cond, real = gate_split(cfg) if data is None else data
        engine = FastSim.from_checkpoint(
            cfg, DIR_MODELS.format(EXPERIMENT_DIR_NAME=exp_dir), epoch,
            use_ema=weights == "ema", batch_size=min(2048, len(cond)), precision=precision,
            device=dev)
        checkpoint = f"{exp_dir}@{epoch}"
        label = f"{os.path.basename(os.path.normpath(exp_dir))}@{epoch}"
    else:
        gp, gs, rp, meta = load_serving_artifact(art_path) if loaded is None else loaded
        cfg = load_config([*GATE_OVERRIDES, *_artifact_model_config(meta), *overrides])
        cond, real = gate_split(cfg) if data is None else data
        engine = FastSim(gp, rp, batch_size=min(2048, len(cond)), precision=precision,
                         device=dev, cfg=cfg, gen_stats=gs)
        label = os.path.basename(art_path)
        checkpoint = f"{art_path} (from {meta.get('source', '?')})"

    ch_real = expm1_channel_sums(torch.as_tensor(real).to(dev))
    ch_gens = []
    for d in range(n_draws):
        gen = torch.Generator(device=dev).manual_seed(100 + d)
        showers, ids = engine.simulate_bulk(cond, generator=gen, return_experts=True)
        ch_gens.append(sum_channels(showers))
        if d == 0:
            hist = torch.bincount(ids, minlength=engine.n_experts).tolist()
            print(f"fidelity_torch: {label} {precision}: routing of the "
                  f"{len(cond)} test conditions to experts {hist}", flush=True)
    record = fidelity_record(ch_real, ch_gens, meta)
    epoch = int(float(meta.get("epoch", -1)))
    student = meta.get("weights") == "distilled-student"
    record.update({
        "checkpoint": checkpoint,
        "weights": "ema" if meta.get("weights", "ema") == "ema" else "raw",
        "precision": precision,
        "n_test": int(len(cond)),
    })
    if "family" in meta:
        record["family"] = meta["family"]
    if student:
        record["width"] = float(meta.get("width", 1.0))
        if "teacher_x_floor" in meta:
            record["teacher_x_floor"] = float(meta["teacher_x_floor"])
    if 0 <= epoch + 1 < CALIBRATION_EPOCHS and not student:
        record["warning"] = (
            f"weights trained {epoch + 1} epochs; the {CRITERION}x criterion was calibrated "
            f"at {CALIBRATION_EPOCHS}: a FAIL here may be a training-length artifact")
    record["device"] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Fidelity gate of the PyTorch port.")
    ap.add_argument("target", nargs="?", default=None,
                    help="'artifact', a serving artifact *.npz, a run directory of the port's "
                         "checkpoints, or nothing for the default")
    ap.add_argument("precision", nargs="?", default="int8",
                    help="FastSim precision (default int8, as fidelity.py)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="a run directory's checkpoint epoch (default: the latest)")
    ap.add_argument("--weights", choices=("ema", "raw"), default="ema",
                    help="a run directory's EMA or raw generator weights (default ema)")
    ap.add_argument("--override", nargs="*", default=[],
                    help="config overrides a.b=c after the gate's (a run's model options)")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    try:
        record = run_gate(args.target, args.precision, args.device, epoch=args.epoch,
                          weights=args.weights, overrides=args.override)
    except FileNotFoundError as e:  # fidelity.py's record of nothing to gate
        print(json.dumps({"metric": "fastsim_fidelity", "value": None, "error": str(e)}),
              flush=True)
        return 1
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
