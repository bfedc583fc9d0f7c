#!/usr/bin/env python3
"""Training-throughput benchmark of the PyTorch port (the port of ``train_bench.py``).

    python3 train_bench_torch.py              # one CUDA card, batch 512, E=3, bf16
    python3 train_bench_torch.py --cpu --width 0.125 --batch 8 --tile 4 --steps 2   # tiny

The last line of standard output is one JSON object with
``train_bench.py``'s keys: ``{"metric": "train_step_throughput", "value":
<samples/s of the switch arm>, "unit": "samples/sec/chip", "vs_baseline":
<dense ms / switch ms>, "scale": {...}, "dense": {...}, "switch": {...}}``.

The whole MoE train step (D, G and aux, EMA, router) of the proton family
at ``train_bench.py``'s scale: batch 512, 3 experts, ``train.precision=bf16``,
random weights from ``--seed``. Two arms, as ``train_bench.py:96-109``:

- ``dense``: the dense bf16 step with the differentiable router GAN term;
- ``switch``: the tiled switch at ``train.dispatch_tile=128`` with
  ``train.dispatch_remat`` and the constant router GAN term.

Each arm: one warm step, one step under ``torch.utils.flop_counter``
(its floating-point operations, the recomputed forwards included), then
``--steps`` steps chained through the state, each on its own draws
(``draw_step_noise``, as the training loop draws them), timed with CUDA
events around the chain and one synchronise at its end. The batch and the
draws come from ``torch.Generator``s seeded from ``--seed``. An arm reports
``ms_per_step``, ``steps_per_sec``, ``samples_per_sec``, ``tflop_per_step``,
``tflops_achieved``, ``bf16_peak_frac`` (against the H100's dense bf16
peak, 989 TFLOP/s; ``null`` on the CPU) and ``peak_mem_gib``
(``torch.cuda.max_memory_allocated``; ``null`` on the CPU). ``scale``
names the card and its power limit (``nvidia-smi``).

It runs on the card, and fails without one, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BF16_PEAK = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
N_EXPERTS = 3  # train_bench.py:101


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def make_batch(b, device, seed):
    """``train_bench.py``'s batch: |N(0, 1)| images, N(0, 1) conditions, U(0, 1)
    std, U(0, 1000) intensities, U(0, 30) positions."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return {"real": torch.randn((b, 56, 30, 1), generator=g, device=device).abs(),
            "cond": torch.randn((b, 9), generator=g, device=device),
            "std": torch.rand((b, 1), generator=g, device=device),
            "intensity": torch.rand((b, 1), generator=g, device=device) * 1000,
            "positions": torch.rand((b, 2), generator=g, device=device) * 30}


def bench_arm(overrides, device, seed, n_steps):
    """One arm's record (see the module docstring)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from zdcsim_torch.config import load_config
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import init_state
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    cfg = load_config(overrides)
    b = int(cfg.train.batch_size)
    mods = build_moe(cfg)
    state = init_state(mods, cfg, seed, device)
    step = build_train_step(mods, cfg)
    batch = make_batch(b, device, seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    cuda = device.type == "cuda"

    def draws():
        return draw_step_noise(gen, mods, b, device, step.switch)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch, draws(), 0)  # warm: cuDNN's choices, the allocator
    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch, draws(), 0)
    flops = counter.get_total_flops()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = step(state, batch, draws(), 0)
    if cuda:
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / n_steps
    else:
        dt = (time.perf_counter() - t0) / n_steps
    if not bool(torch.isfinite(metrics["gen_loss"])):
        raise RuntimeError(f"non-finite gen_loss after {n_steps} steps: {overrides}")
    return {
        "ms_per_step": round(dt * 1e3, 3),
        "steps_per_sec": round(1.0 / dt, 3),
        "samples_per_sec": round(b / dt, 1),
        "tflop_per_step": round(flops / 1e12, 4),
        "tflops_achieved": round(flops / dt / 1e12, 2),
        "bf16_peak_frac": round(flops / dt / BF16_PEAK, 4) if cuda else None,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3) if cuda else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (its test)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--width", type=float, default=1.0, help="the generator's width")
    ap.add_argument("--tile", type=int, default=128, help="the switch arm's dispatch tile")
    ap.add_argument("--steps", type=int, default=16, help="timed steps an arm")
    args = ap.parse_args(argv)

    import torch

    if args.cpu:
        device, card = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            print("train_bench_torch: no CUDA device is visible (use --cpu for the CPU)",
                  file=sys.stderr)
            return 2
        device, card = torch.device("cuda"), card_line()
    base = [f"train.batch_size={args.batch}", f"model.n_experts={N_EXPERTS}",
            f"model.generator.width={args.width}", "train.precision=bf16"]
    dense = bench_arm(base, device, args.seed, args.steps)
    switch = bench_arm(base + ["model.router.differentiable_gan_term=false",
                               "train.dispatch=switch", f"train.dispatch_tile={args.tile}",
                               "train.dispatch_remat=true"], device, args.seed, args.steps)
    print(json.dumps({
        "metric": "train_step_throughput",
        "value": switch["samples_per_sec"],
        "unit": "samples/sec/chip",
        "vs_baseline": round(dense["ms_per_step"] / switch["ms_per_step"], 3),
        "scale": {"batch": args.batch, "n_experts": N_EXPERTS, "precision": "bf16",
                  "width": args.width, "tile": args.tile, "steps": args.steps, "card": card},
        "dense": dense,
        "switch": switch,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
