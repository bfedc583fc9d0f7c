#!/usr/bin/env python3
"""Fast-sim throughput benchmark of the PyTorch port (the port of ``bench.py``).

    python3 bench_torch.py                  # one CUDA card: the first rung that serves
    python3 bench_torch.py --all            # every rung, each printed to stderr
    python3 bench_torch.py --all --tiles 64,128,256   # the teacher's rungs at each tile
    python3 bench_torch.py --cpu --n-showers 16 --batch 8 --tile 4   # tiny, on the CPU

The last line of standard output is one JSON object with ``bench.py``'s
keys, ``{"metric": "fastsim_throughput", "value": N, "unit":
"showers/sec/chip", "vs_baseline": N / 50000}``, and ``rung``: the artifact,
precision, batch and tile that served it (``null``, with ``value`` 0 and exit
code 1, when every rung failed or a rung that runs a hand-written kernel
failed). ``value`` is the median of ``REPEATS`` timed runs.

Rungs, in order (as ``bench.py``, the first that serves wins):

1. ``STUDENT_LADDER``: the distilled students, each at its own tile,
   ``batch_size=32768``, ``throughput_bulk(n_showers=262144)`` on
   ``precision="int8"`` through ``dyn_dispatch``, which the card replays
   as a CUDA graph per chunk. The students are held against the JAX package
   in ``tests/test_torch_student.py``.
2. ``TEACHER_LADDER``: the committed full-width teacher
   (``artifacts/gate/gate_serving_weights.npz``; the port has no random
   initialisation) on each precision in its faster dispatch form (the eager
   switch loop, which copies no weights per tile, at tile 256), ordered by
   the rates measured on an H100 with this script (``PERF.md``), not by
   ``bench.py``'s TPU order. ``--all`` times each precision in both forms:
   the switch loop and the CUDA graph of the dyn tile loop.

Standard error gets, for each rung: every timed rate and their spread, the
routing histogram of the served conditions (the teacher's router sends every
condition to expert 1), and ``torch.cuda.max_memory_allocated`` over the
rung. A rung that fails prints its exception and names itself; the next rung
serves, unless the failed one runs a hand-written kernel
(``KERNEL_PRECISIONS``): then the bench stops and reports no rate, so that a
kernel that does not build or launch never shows as a plain rung's rate.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_SHOWERS_PER_SEC = 50_000.0
# (artifact, dispatch tile) fastest first, as bench.py:33-39
STUDENT_LADDER = (
    ("artifacts/gate/student_w0.125_serving_weights.npz", 128),
    ("artifacts/gate/student_w0.1875_serving_weights.npz", 256),
    ("artifacts/gate/student_w0.25_serving_weights.npz", 128),
    ("artifacts/gate/student_w0.375_serving_weights.npz", 128),
    ("artifacts/gate/student_w0.5_serving_weights.npz", 128),
)
STUDENT_BATCH, STUDENT_SHOWERS = 32768, 262144
REPEATS = 3  # timed runs of each rung
TEACHER = "artifacts/gate/gate_serving_weights.npz"
# (precision, batch, tile, showers, dyn_dispatch), fastest first: the medians
# of `--all` at tiles 64, 128 and 256 on an H100 80GB HBM3 at 700 W (PERF.md
# §5), where tile 256 was the fastest of the three on every precision and
# the eager switch loop beat the dyn graph there on every precision
TEACHER_LADDER = (
    ("int8_fused", 32768, 256, 131072, False),
    ("bf16", 8192, 256, 32768, False),
    ("int8_pallas", 32768, 256, 65536, False),
    ("int8_fused_front", 32768, 256, 32768, False),
    ("int8_pallas_ab", 32768, 256, 32768, False),
    ("int8", 32768, 256, 32768, False),
    ("f32", 8192, 256, 16384, False),
)
# the precisions that run the hand-written kernels (A-D, G, H): a failure
# there ends the bench instead of passing to a plain rung
KERNEL_PRECISIONS = ("int8_pallas_ab", "int8_pallas", "int8_fused_front", "int8_fused")


def log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def ladder(tiles=None, both_forms=False):
    """Every rung as ``{"artifact", "precision", "batch_size", "tile",
    "n_showers", "dyn_dispatch"}``, in order; ``tiles`` replaces each teacher
    rung's tile by each of them, and ``both_forms`` times each teacher rung
    in the switch form and then the dyn form."""
    rungs = [{"artifact": path, "precision": "int8", "batch_size": STUDENT_BATCH, "tile": tile,
              "n_showers": STUDENT_SHOWERS, "dyn_dispatch": True}
             for path, tile in STUDENT_LADDER]
    for precision, batch, tile, n, dyn in TEACHER_LADDER:
        for t in tiles or (tile,):
            for d in (False, True) if both_forms else (dyn,):
                rungs.append({"artifact": TEACHER, "precision": precision, "batch_size": batch,
                              "tile": t, "n_showers": n, "dyn_dispatch": d})
    return rungs


def run_rung(rung, device, repeats: int, seed: int = 0):
    """Serve one rung ``repeats`` times through ``throughput_bulk`` (the first
    call warms up, capturing the graph on the card). Returns ``{"rates",
    "median", "routing", "peak_bytes"}``."""
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    gp, _, rp, meta = load_serving_artifact(os.path.join(HERE, rung["artifact"]))
    cfg = load_config([f"model.generator.width={float(meta.get('width', 1.0))}"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    engine = FastSim(gp, rp, batch_size=rung["batch_size"], precision=rung["precision"],
                     device=device, cfg=cfg)
    engine._build_switch(tile=rung["tile"], dyn_dispatch=rung["dyn_dispatch"])
    n = rung["n_showers"]
    # throughput_bulk draws its conditions first from the generator: route those
    cond = torch.randn((n, engine.cond_dim), generator=torch.Generator(device).manual_seed(seed),
                       device=device)
    routing = torch.bincount(engine._route(cond), minlength=engine.n_experts).tolist()
    rates = []
    for r in range(repeats):
        stats = engine.throughput_bulk(n_showers=n, warmup=r == 0,
                                       generator=torch.Generator(device).manual_seed(seed))
        rates.append(stats["showers_per_sec"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return {"rates": rates, "median": statistics.median(rates), "routing": routing,
            "peak_bytes": peak}


def describe(rung) -> str:
    return (f"{os.path.basename(rung['artifact'])} {rung['precision']} batch "
            f"{rung['batch_size']} tile {rung['tile']} n {rung['n_showers']} "
            f"{'dyn (a CUDA graph on the card)' if rung['dyn_dispatch'] else 'switch (eager)'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="time every rung, not just the first, the teacher's in both dispatch forms")
    ap.add_argument("--tiles", default=None,
                    help="comma-separated tiles for each teacher rung (a tile sweep)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (its test)")
    ap.add_argument("--n-showers", type=int, default=None, help="override every rung's showers")
    ap.add_argument("--batch", type=int, default=None, help="override every rung's batch")
    ap.add_argument("--tile", type=int, default=None, help="override every rung's tile")
    args = ap.parse_args(argv)

    import torch

    if args.cpu:
        device, card = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            print("bench_torch: no CUDA device is visible (use --cpu for the CPU)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    tiles = [int(t) for t in args.tiles.split(",")] if args.tiles else None
    best = None
    for rung in ladder(tiles, both_forms=args.all):
        for key, value in (("n_showers", args.n_showers), ("batch_size", args.batch),
                           ("tile", args.tile)):
            if value is not None:
                rung[key] = value
        if not os.path.exists(os.path.join(HERE, rung["artifact"])):
            log(f"{describe(rung)}: no artifact, skipped")
            continue
        t = time.perf_counter()
        try:
            res = run_rung(rung, device, REPEATS)
        except Exception:  # noqa: BLE001 — the bench always prints a number
            log(f"{describe(rung)} failed:\n{traceback.format_exc()}")
            if rung["precision"] in KERNEL_PRECISIONS:
                log("a rung that runs a hand-written kernel failed: no rate is reported")
                report(None)
                return 1
            continue
        rates, med = res["rates"], res["median"]
        spread = (max(rates) - min(rates)) / med
        peak = res["peak_bytes"]
        log(f"{describe(rung)} on {card}: showers/s " + " ".join(f"{r:.1f}" for r in rates)
            + f"; median {med:.1f}, spread (max - min) / median {spread:.4f}; routing "
            f"{res['routing']}; peak device memory "
            + (f"{peak} bytes ({peak / 2**30:.3f} GiB)" if peak is not None else "not measured")
            + f"; {time.perf_counter() - t:.1f}s")
        if best is None:
            best = (rung, med)
            if not args.all:
                break
    if best is None:
        log("every rung failed")
    report(best)
    return 0 if best else 1


def report(best) -> None:
    """The last line: ``bench.py``'s keys and ``rung``; ``best`` is
    ``(rung, median)``, or ``None`` for no rate."""
    value = best[1] if best else 0.0
    print(json.dumps({
        "metric": "fastsim_throughput",
        "value": round(value, 1),
        "unit": "showers/sec/chip",
        "vs_baseline": round(value / BASELINE_SHOWERS_PER_SEC, 3),
        "rung": best[0] if best else None,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
