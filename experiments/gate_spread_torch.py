"""Spreads of the port's fidelity numbers over noise seeds, beside the JAX
package's on the same inputs.

    python experiments/gate_spread_torch.py gate [--seeds 5]          # CPU, both packages
    python experiments/gate_spread_torch.py int8 --package port       # on CUDA (or --device cpu)
    python experiments/gate_spread_torch.py int8 --package jax        # CPU

``gate``: the fidelity gate of the w=0.125 proton student
(``artifacts/gate/student_w0.125_serving_weights.npz``, ``int8``) on the
gate's test split, one noise draw per seed: the port's ``run_gate`` with
its ``torch.Generator`` seeded ``100 + s``, and ``fidelity.py``'s
computation (JAX's ``FastSim.simulate_bulk`` on ``PRNGKey(100 + s)``, its
channel sums and W1 against the same floor), for ``s`` in ``0 .. seeds-1``;
the gate itself averages the draws of seeds 0-2. Prints one JSON line per
package with each seed's ``x_floor`` value, their mean, standard deviation,
minimum, maximum and the 3-draw mean.

``int8``: ``chip_smoke.py`` phase 16's ``int8``-against-``f32`` check of the
neutron w=0.125 student for ``--seeds`` seeds from ``--first`` (its
router, conditions and noise drawn from ``default_rng([seed, 16])`` in the
phase's order, 65536 showers): the largest relative difference of the per-shower log1p
photon sums between the two serves, beside the phase's bound 0.15. With
``--package port`` the port serves (``int8`` through the dyn tile loop,
batch 32768, tile 128, against ``f32``). With ``--package jax`` JAX's
``fast_neutron_apply`` runs the same rows, conditions and noise, each
expert on its routed rows in tiles of 128 (the last one filled with copies
of its first row, which leave the per-tile activation maxima as they are),
``int8`` on bfloat16 operands as JAX's engine serves it, against float32.
Prints one JSON line with each seed's value and per-expert values.

The port's mode imports no JAX; the JAX modes import the JAX package and
run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STUDENT = os.path.join(REPO, "artifacts", "gate", "student_w0.125_serving_weights.npz")
NEUTRON_STUDENT = os.path.join(REPO, "artifacts", "gate",
                               "neutron_student_w0.125_serving_weights.npz")
INT8_SHOWERS, INT8_BATCH, INT8_TILE = 65536, 32768, 128  # chip_smoke.NEUTRON_SERVE["student"]


def summary(values: List[float]) -> Dict[str, object]:
    v = np.asarray(values, np.float64)
    return {"values": [float(x) for x in v], "mean": float(v.mean()), "std": float(v.std(ddof=1)),
            "min": float(v.min()), "max": float(v.max())}


# -- F2: the gate over draw seeds ----------------------------------------------


def port_gate(seeds: int) -> Dict[str, object]:
    """The port's gate of the proton student, one draw a seed, on the CPU."""
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.ops.channels import sum_channels
    from zdcsim_torch.ops.epilogue_kernels import expm1_channel_sums
    from zdcsim_torch.utils.artifact import load_serving_artifact

    gp, gs, rp, meta = load_serving_artifact(STUDENT)
    cfg = load_config([*ft.GATE_OVERRIDES, *ft._artifact_model_config(meta)])
    cond, real = ft.gate_split(cfg)
    ch_real = expm1_channel_sums(torch.as_tensor(real))
    eng = FastSim(gp, rp, batch_size=2048, precision="int8", device="cpu", cfg=cfg,
                  gen_stats=gs)
    ch_gens = [sum_channels(eng.simulate_bulk(cond, generator=torch.Generator().manual_seed(
        100 + s))) for s in range(seeds)]
    values = [ft.fidelity_record(ch_real, [g], meta)["value"] for g in ch_gens]
    three = ft.fidelity_record(ch_real, ch_gens[:3], meta)["value"]
    return {"package": "port", **summary(values), "gate_3_draws": three, "n_test": len(cond)}


def jax_gate(seeds: int) -> Dict[str, object]:
    """``fidelity.py``'s computation on the same student and split (JAX, CPU)."""
    from zdcsim.utils.platform import force_cpu

    force_cpu()
    import jax
    import jax.numpy as jnp

    import fidelity
    from zdcsim.config import load_config
    from zdcsim.data import get_train_test_data, make_loaders
    from zdcsim.inference import FastSim
    from zdcsim.models import build_moe
    from zdcsim.ops.channels import sum_channels
    from zdcsim.ops.ws import wasserstein_per_channel
    from zdcsim.utils.artifact import load_serving_artifact

    gp, gs, rp, meta = load_serving_artifact(STUDENT)
    extra, cfg_path = fidelity._artifact_model_config(meta)
    cfg = load_config(cfg_path, overrides=[
        "dataset.synthetic=true", "dataset.synthetic_n_samples=25600", "train.batch_size=512",
        "model.n_experts=3", "train.seed=7", *extra])
    _, test_loader = make_loaders(cfg, get_train_test_data(cfg))
    cond, real = test_loader.arrays["cond"], test_loader.arrays["real"]
    ch_real = sum_channels(jnp.expm1(real[..., 0] if real.ndim == 4 else real))
    n = int(cond.shape[0])
    perm = np.random.default_rng(0).permutation(n)
    half = n // 2
    ch_perm = ch_real[perm]
    floor = float(jnp.mean(wasserstein_per_channel(ch_perm[:half], ch_perm[half:2 * half])))
    engine = FastSim(build_moe(cfg), gp, gs, rp, batch_size=2048, precision="int8")
    values = []
    for s in range(seeds):
        ch_gen = sum_channels(jnp.asarray(engine.simulate_bulk(cond, jax.random.PRNGKey(100 + s))))
        values.append(float(jnp.mean(wasserstein_per_channel(
            ch_perm[:half], ch_gen[perm][half:2 * half]))) / floor)
    return {"package": "jax", **summary([round(v, 3) for v in values]),
            "gate_3_draws": round(float(np.mean(values[:3])), 3), "n_test": n}


# -- F3: phase 16's int8-against-f32 check over --seed -------------------------


def int8_inputs(seed: int):
    """Phase 16's router, conditions and noise for ``--seed`` (the student's
    rows are the first ``INT8_SHOWERS``)."""
    import chip_smoke as cs

    rng = np.random.default_rng([seed, 16])
    router = cs.spread_router(rng)
    cs.neutron_batch_tree(rng)  # the phase draws its random norm=batch tree next
    cond, noise = cs.engine_conditions(rng, None, INT8_SHOWERS, False)
    return router, cond[:INT8_SHOWERS], noise[:INT8_SHOWERS]


def rel_diff(a_sums: np.ndarray, b_sums: np.ndarray, ids: np.ndarray) -> Dict[str, object]:
    """The phase's number: max relative difference of the log1p sums, and per expert."""
    rel = np.abs(a_sums - b_sums) / np.abs(b_sums)
    return {"max_rel": float(rel.max()),
            "per_expert": [float(rel[ids == e].max()) if (ids == e).any() else None
                           for e in range(3)]}


def port_int8(seed: int, device) -> Dict[str, object]:
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    router, cond, noise = int8_inputs(seed)
    gp, gs, _, meta = load_serving_artifact(NEUTRON_STUDENT)
    cfg = load_config(ft._artifact_model_config(meta))
    eng = FastSim(gp, router, batch_size=INT8_BATCH, precision="int8", device=device, cfg=cfg,
                  gen_stats=gs)
    eng._build_switch(tile=INT8_TILE, dyn_dispatch=True)
    imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
    ref = FastSim(gp, router, batch_size=INT8_BATCH, precision="f32", device=device, cfg=cfg,
                  gen_stats=gs)
    ref._build_switch(tile=INT8_TILE)
    r_imgs, r_ids = ref.simulate_switch(cond, noise=noise, return_experts=True)
    if not torch.equal(ids, r_ids):
        raise SystemExit(f"seed {seed}: int8 and f32 route differently")
    sums = np.log1p(imgs.sum(dim=(1, 2)).cpu().numpy())
    r_sums = np.log1p(r_imgs.sum(dim=(1, 2)).cpu().numpy())
    return {"seed": seed, **rel_diff(sums, r_sums, ids.cpu().numpy())}


def jax_int8(seed: int) -> Dict[str, object]:
    from zdcsim.utils.platform import force_cpu

    force_cpu()
    import jax
    import jax.numpy as jnp

    from zdcsim.models.neutron_fast import fast_neutron_apply
    from zdcsim.models.router import RouterNetwork
    from zdcsim.utils.artifact import load_serving_artifact

    router, cond, noise = int8_inputs(seed)
    gp, _, _, _ = load_serving_artifact(NEUTRON_STUDENT)
    _, logits = RouterNetwork(n_experts=3).apply({"params": router}, jnp.asarray(cond))
    ids = np.asarray(jnp.argmax(logits, axis=-1))

    def tiles(rows):
        pad = (-len(rows)) % INT8_TILE
        return np.concatenate([rows, np.full(pad, rows[0])]).reshape(-1, INT8_TILE)

    sums = {}
    for name, int8, dt in (("int8", True, jnp.bfloat16), ("f32", False, jnp.float32)):
        out = np.zeros(len(cond), np.float64)
        for e in range(3):
            rows = np.flatnonzero(ids == e)
            if not len(rows):
                continue
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[e], dt), gp)
            t = tiles(rows)
            fn = jax.jit(jax.vmap(lambda z, c: jnp.expm1(fast_neutron_apply(
                p, z, c, int8=int8)[..., 0].astype(jnp.float32)).sum(axis=(1, 2))))
            got = np.concatenate([np.asarray(fn(jnp.asarray(noise[b], dt), jnp.asarray(cond[b], dt)))
                                  for b in np.array_split(t, max(1, len(t) // 64))])
            out[t.reshape(-1)[:len(rows)]] = got.reshape(-1)[:len(rows)]
        sums[name] = np.log1p(out)
    return {"seed": seed, **rel_diff(sums["int8"], sums["f32"], ids)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("gate", "int8"))
    ap.add_argument("--package", choices=("port", "jax", "both"), default="both")
    ap.add_argument("--seeds", type=int, default=5, help="the number of seeds")
    ap.add_argument("--first", type=int, default=0, help="the first seed (int8)")
    ap.add_argument("--device", default=None, help="the port's int8 mode: 'cpu' (default CUDA)")
    a = ap.parse_args(argv)
    packages = ("port", "jax") if a.package == "both" else (a.package,)
    for package in packages:
        if a.what == "gate":
            rec = port_gate(a.seeds) if package == "port" else jax_gate(a.seeds)
        else:
            if package == "port":
                from zdcsim_torch.device import default_device

                dev = default_device(a.device)
                runs = [port_int8(s, dev) for s in range(a.first, a.first + a.seeds)]
            else:
                runs = [jax_int8(s) for s in range(a.first, a.first + a.seeds)]
            rec = {"package": package, "bound": 0.15, "seeds": runs,
                   **summary([r["max_rel"] for r in runs])}
        print(json.dumps({a.what: rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
