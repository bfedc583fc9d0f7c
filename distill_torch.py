#!/usr/bin/env python3
"""Serving-time distillation of the PyTorch port (the twin of
``experiments/distill_r4.py`` and ``experiments/distill_neutron_r4.py``).

    python3 distill_torch.py --family proton --width 0.125 --out student.npz  # on CUDA
    python3 distill_torch.py --family neutron --width 0.125 --out /tmp/s.npz
    python3 distill_torch.py --family proton --steps 25 --batch 4 --n-samples 400 \\
        --n-gate 16 --draws 1 --device cpu --out /tmp/s.npz       # a tiny CPU run

Loads the committed teacher artifact (``artifacts/gate/gate_serving_weights.npz``
or ``neutron_teacher_serving_weights.npz``), distils it into a student of
``--width`` (proton: ``Generator(width=w)``; neutron:
``GeneratorNeutron(norm="none", width=w)``, whose tree is the folded serving
layout) on the conditions of the gate's train side (``y_train`` of the
synthetic split of ``fidelity_torch.GATE_OVERRIDES``), with cosine-decayed
Adam, ``--steps`` updates of ``--batch`` draws
(``zdcsim_torch.inference.distill``). The teacher is the scripts' bf16
serving forward behind its own router. Then both are gated through
``fidelity_torch.run_gate`` on ``int8`` (the first ``--n-gate`` test
conditions, ``--draws`` noise draws): the proton student passes at the
gate's 1.5x floor, the neutron student at ``NEUTRON_REL_CRITERION`` x the
teacher's value. The student is written with ``save_serving_artifact`` to
``--out`` (required; never under ``artifacts/``, where the committed
artifacts live), with the scripts' meta keys, pass or fail. The last line
of standard output is one JSON record: ``width``, ``fidelity_x_floor``,
``teacher_x_floor``, ``pass``, ``distill_metrics``, ``steps``, ``seconds``
(the distillation's), ``device``, and ``family``, ``out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from fidelity_torch import CRITERION, GATE_OVERRIDES, NEUTRON_REL_CRITERION, N_DRAWS
from zdcsim_torch.config import NEUTRON_OVERRIDES

HERE = os.path.dirname(os.path.abspath(__file__))
TEACHERS = {"proton": os.path.join(HERE, "artifacts", "gate", "gate_serving_weights.npz"),
            "neutron": os.path.join(HERE, "artifacts", "gate",
                                    "neutron_teacher_serving_weights.npz")}


def _check_out(path: str) -> str:
    out = os.path.realpath(path)
    if os.path.commonpath([out, os.path.realpath(os.path.join(HERE, "artifacts"))]) == \
            os.path.realpath(os.path.join(HERE, "artifacts")):
        raise ValueError(f"--out {path}: distill_torch.py does not write under artifacts/")
    return out


def family_overrides(family: str) -> List[str]:
    """The model recipe of the family's teacher: the neutron preset with
    ``model.norm=group`` (``distill_neutron_r4.py``'s ``BASE``)."""
    return [*NEUTRON_OVERRIDES, "model.norm=group"] if family == "neutron" else []


def student_meta(family: str, width: float, teacher_meta: Dict[str, str], teacher_src: str,
                 fid_s: float, fid_t: float, steps: int) -> Dict[str, object]:
    """The meta keys of ``distill_r4.py:210-215`` / ``distill_neutron_r4.py:236-241``."""
    if family == "proton":
        return {"epoch": int(float(teacher_meta.get("epoch", -1))),
                "weights": "distilled-student", "width": width, "source": teacher_src,
                "fidelity_x_floor": round(fid_s, 3), "steps": steps}
    return {"weights": "distilled-student", "family": "neutron", "norm": "none",
            "width": width, "source": teacher_src, "fidelity_x_floor": round(fid_s, 3),
            "teacher_x_floor": round(fid_t, 3), "steps": steps}


def distill(family: str = "proton", width: float = 0.125, steps: int = 3000,
            batch: int = 512, lr: float = 2e-3, seed: int = 21, inner_steps: int = 25,
            out: str = "student_serving_weights.npz", device=None, n_samples: int = 25600,
            n_gate: Optional[int] = None, draws: int = N_DRAWS,
            logger=print) -> Dict[str, object]:
    """Distil, gate and write one student; returns the record."""
    import numpy as np
    import torch

    import fidelity_torch
    from zdcsim_torch.config import load_config
    from zdcsim_torch.convert import (
        from_jax_params, from_state_dict, to_state_dict, tree_to_torch,
    )
    from zdcsim_torch.data.dataset import get_train_test_data
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.device import default_device
    from zdcsim_torch.inference.distill import (
        distill_generator, module_teacher, proton_teacher, router_argmax,
    )
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import _init_params
    from zdcsim_torch.utils.artifact import load_serving_artifact, save_serving_artifact

    out = _check_out(out)
    dev = default_device(device)
    gp, gs, rp, t_meta = load_serving_artifact(TEACHERS[family])
    teacher_src = f"artifact (from {t_meta.get('source', '?')})"
    logger(f"teacher: {teacher_src}")
    base = [*family_overrides(family), *GATE_OVERRIDES,
            f"dataset.synthetic_n_samples={n_samples}"]
    cfg = load_config(base)
    cfg_w = load_config([*base, f"model.generator.width={width}"]
                        + (["model.norm=none"] if family == "neutron" else []))
    split = get_train_test_data(cfg)
    test = split_to_arrays(split, False)
    n_test = len(test["cond"]) if n_gate is None else min(int(n_gate), len(test["cond"]))
    data = (test["cond"][:n_test], test["real"][:n_test, ..., 0])

    gen, router_sd = from_jax_params(gp, rp)
    if family == "proton":
        teacher_apply = proton_teacher(gen, dev)
    else:
        modules = build_moe(cfg)
        params = {k: v.to(dev) for k, v in to_state_dict(gp, stacked=True).items()}
        teacher_apply = module_teacher(modules, params)
    router_apply = router_argmax(cfg.model, router_sd, dev)
    t_rec = fidelity_torch.run_gate(TEACHERS[family], "int8", dev, data=data, n_draws=draws)
    fid_t = float(t_rec["value"])
    logger(f"teacher fidelity: {fid_t:.3f}x floor ({n_test} test conditions, {draws} draws)")

    student = build_moe(cfg_w)
    gen_rng = torch.Generator(device=dev).manual_seed(int(seed))
    s_params = _init_params(student.generator, student.n_experts, gen_rng, dev)
    cond_pool = torch.as_tensor(np.asarray(split.y_train, np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    s_params, metrics = distill_generator(
        student, s_params, teacher_apply, router_apply, cond_pool, gen_rng, student.noise_dim,
        steps=steps, batch_size=batch, lr=lr, inner_steps=inner_steps, logger=logger)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    logger(f"width={width}: distilled {steps} steps in {seconds:.1f}s final={metrics}")

    s_gp = from_state_dict(s_params, stacked=True)
    meta = student_meta(family, width, t_meta, teacher_src, 0.0, fid_t, steps)
    s_rec = fidelity_torch.run_gate(f"{family} student w={width}", "int8", dev, data=data,
                                    n_draws=draws, loaded=(s_gp, {}, rp, meta))
    fid_s = float(s_rec["value"])
    ok = fid_s <= (CRITERION if family == "proton" else NEUTRON_REL_CRITERION * fid_t)
    meta = student_meta(family, width, t_meta, teacher_src, fid_s, fid_t, steps)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_serving_artifact(out, tree_to_torch(s_gp), {}, router_sd, meta=meta)
    logger(f"wrote {out}")
    return {
        "family": family, "width": width, "fidelity_x_floor": round(fid_s, 3),
        "teacher_x_floor": round(fid_t, 3), "pass": bool(ok), "distill_metrics": metrics,
        "steps": steps, "seconds": seconds, "out": out,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Distil a committed teacher into a student.")
    ap.add_argument("--family", choices=("proton", "neutron"), default="proton")
    ap.add_argument("--width", type=float, default=0.125)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=21,
                    help="seeds the student's initialisation and the draws")
    ap.add_argument("--inner-steps", type=int, default=25)
    ap.add_argument("--out", required=True,
                    help="the student's artifact (*.npz; not under artifacts/)")
    ap.add_argument("--n-samples", type=int, default=25600,
                    help="synthetic events of the gate's split (fewer for a quick run)")
    ap.add_argument("--n-gate", type=int, default=None,
                    help="gate on the first N test conditions (default: all)")
    ap.add_argument("--draws", type=int, default=N_DRAWS, help="noise draws of each gate")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: CUDA)")
    a = ap.parse_args(argv)
    rec = distill(a.family, a.width, a.steps, a.batch, a.lr, a.seed, a.inner_steps, a.out,
                  a.device, a.n_samples, a.n_gate, a.draws,
                  logger=lambda m: print(m, flush=True))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
