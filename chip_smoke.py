#!/usr/bin/env python3
"""Smoke run of the zdcsim_torch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse-cpu  # phases 3-5 on the CPU at batch 8
    python3 chip_smoke.py --profile       # adds a profile of the serve

Phases, each printing one line with its elapsed seconds:

1. the card: name, device count and ``nvidia-smi`` name / power limit;
2. the build of the CUDA kernels (seconds, ptxas register/smem report);
3. kernel A (LN + leaky + int8) against its plain version at [256, 92160];
4. kernel B (up2 + conv4 int8) against its plain version at [64, 18, 10, 512];
5. serving the full-width proton teacher's generator
   (artifacts/gate/gate_serving_weights.npz) through
   ``FastSim(precision="int8_pallas_ab")``: 16384 showers, launch counts,
   output checks, agreement with ``precision="int8"``, rate and peak memory.
   The teacher's router sends every condition to expert 1, so the serve
   routes with a router drawn from ``--seed`` and fails unless every expert
   decodes showers;
6. kernel times with CUDA events at the serving tile (64 rows).

``--profile`` adds a ``torch.profiler`` trace of one serve of 16384 showers
(printed as a table, not written to disk): device time per kernel and the
device's idle share of the serve's wall time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line is printed. Without a CUDA device the script exits with code 2 and
prints no result; ``--rehearse-cpu`` ends with ``{"rehearsal": true}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TEACHER = os.path.join(HERE, "artifacts", "gate", "gate_serving_weights.npz")
N_SHOWERS = 16384
SERVE_BATCH, SERVE_TILE = 4096, 64  # bench.py's teacher ladder tile
A_ROWS, B_ROWS, TIME_ROWS = 256, 64, 64
# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] t={time.perf_counter() - T0:.2f}s {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi printed no card")
    return out.splitlines()[0].strip()


def bf16_ulp(t):
    import torch

    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def check_kernel_a(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    # as the engine holds them: bf16 weights, cast to f32 by quantize_weights
    ln = gp["MLPBlock_1"]["LayerNorm_0"]
    scale = torch.as_tensor(ln["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(ln["bias"][0]).to(dev, torch.bfloat16).float()
    f = scale.shape[0]
    y = torch.as_tensor(rng.standard_normal((rows, f), dtype="float32") * 3.0).to(dev, torch.bfloat16)
    q, s = dk.ln_leaky_rowquant(y, scale, bias)
    qp, sp = dk.ln_leaky_rowquant_plain(y, scale, bias)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    log("3 kernel A", f"[{rows}, {f}] bf16: max s rel err {s_rel:.3e} (rtol 1e-6), "
        f"max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%)")
    if not (s_rel <= 1e-6 and q_max <= 1 and flips < 0.01):
        fail("kernel A disagrees with its plain version")
    return y, scale, bias, float(q_max)


def check_kernel_b(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_0"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    kq, sk = dk._quant_phases(kernel)
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 18, 10, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    out = dk.up2_conv4_int8(xq, sx, kq, sk, bias, out_dtype=torch.float32)
    ref = dk.up2_conv4_int8_plain(xq, sx, kq, sk, bias, out_dtype=torch.float32)
    outb = dk.up2_conv4_int8(xq, sx, kq, sk, bias, out_dtype=torch.bfloat16)
    refb = dk.up2_conv4_int8_plain(xq, sx, kq, sk, bias, out_dtype=torch.bfloat16)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = (out - ref).abs()
    ok32 = bool((err <= 1e-5 + 1e-5 * ref.abs()).all())
    errb = (outb.float() - refb.float()).abs()
    okb = bool((errb <= bf16_ulp(refb.float())).all())
    log("4 kernel B", f"[{rows}, 18, 10, {cin}] -> {tuple(out.shape)}: f32 max abs err "
        f"{err.max().item():.3e} (rtol=atol=1e-5: {ok32}), bf16 max abs err "
        f"{errb.max().item():.3e} (within one bf16 ulp: {okb})")
    if not (ok32 and okb):
        fail("kernel B disagrees with its plain version")
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kq, sk, bias, err.max().item()


def seeded_router(rng, n_experts=3, widths=(9, 128, 64, 32)):
    """A router in the artifact's Flax layout, drawn from ``rng`` (LeCun
    normal kernels, zero biases, as Flax initialises ``nn.Dense``)."""
    import numpy as np

    dims = [*widths, n_experts]
    return {
        f"Dense_{i}": {
            "kernel": (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype("float32"),
            "bias": np.zeros(dims[i + 1], "float32"),
        }
        for i in range(len(dims) - 1)
    }


def serve(gp, rp, rng, dev, n, batch, tile, card, seed, profile=False):
    import numpy as np
    import torch

    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.router import RouterNetwork
    from zdcsim_torch.ops import decode_kernels as dk

    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    teacher_router = RouterNetwork(3)
    teacher_router.load_state_dict(to_state_dict(rp))
    with torch.no_grad():
        t_ids = teacher_router(torch.as_tensor(cond))[1].argmax(-1)
    log("5 serve", f"the teacher's router sends these conditions to experts "
        f"{torch.bincount(t_ids, minlength=3).tolist()}; serving with a router drawn from --seed")
    router = seeded_router(rng)
    eng = FastSim(gp, router, batch_size=batch, precision="int8_pallas_ab", device=dev)
    eng._build_switch(tile=tile)

    dk.ln_leaky_rowquant.launches = 0
    dk.up2_conv4_int8.launches = 0
    t = time.perf_counter()
    imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t
    launches = {"ln_leaky_rowquant": dk.ln_leaky_rowquant.launches,
                "up2_conv4_int8": dk.up2_conv4_int8.launches}
    used = torch.bincount(ids, minlength=3).tolist()
    log("5 serve", f"main path: {n} showers, batch {batch}, tile {tile} in {t_main:.3f}s; "
        f"kernel launches {launches}; showers per expert {used}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"the main path did not launch every kernel: {launches}")
    if min(used) <= 0:
        fail(f"the serve did not decode with every expert: {used}")
    imgs_np, ids_np = imgs.cpu().numpy(), ids.cpu().numpy()
    if imgs_np.shape != (n, 56, 30) or not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
        fail(f"served showers not finite/non-negative of shape ({n}, 56, 30)")
    log("5 serve", f"output {imgs_np.shape} finite and >= 0 (min {imgs_np.min():.3e}, "
        f"max {imgs_np.max():.3e})")

    eng8 = FastSim(gp, router, batch_size=batch, precision="int8", device=dev)
    eng8._build_switch(tile=tile)
    imgs8, ids8 = eng8.simulate_bulk(cond, noise=noise, return_experts=True)
    imgs8, ids8 = imgs8.cpu().numpy(), ids8.cpu().numpy()
    del eng8
    a = np.log1p(imgs_np.sum(axis=(1, 2)))
    b = np.log1p(imgs8.sum(axis=(1, 2)))
    rel = np.abs(a - b) / np.abs(b)
    same_ids = bool((ids_np == ids8).all())
    per_expert = [float(rel[ids8 == e].max()) for e in range(3)]
    log("5 serve", f"vs precision='int8': routing ids identical {same_ids}; "
        f"max rel diff of per-shower log1p sums {rel.max():.4f} (rtol 0.15), "
        f"per expert {[round(x, 4) for x in per_expert]}")
    if not same_ids or rel.max() > 0.15:
        fail("int8_pallas_ab and int8 serving disagree")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        stats = eng.throughput_bulk(n_showers=n, generator=gen)
        peak = torch.cuda.max_memory_allocated(dev)
        log("5 serve", f"throughput_bulk: {stats['showers_per_sec']:.1f} showers/s "
            f"({n} showers in {stats['seconds']:.3f}s, batch {batch}, tile {tile}); "
            f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
        if profile:
            profile_serve(eng, cond, noise, card)
    return launches


def profile_serve(eng, cond, noise, card):
    """One serve under ``torch.profiler``: device time per kernel, and the
    share of the serve's wall time in which no kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.simulate_bulk(cond, noise=noise)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans, per_kernel = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = per_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    if not spans:
        fail("the profiler saw no device activity in the serve")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(v[1] for v in per_kernel.values())
    log("profile", f"serve of {cond.shape[0]} showers: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} [{card}]")
    for name, (count, us) in sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}% {count:6d}x  {name[:110]}", flush=True)


def time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_grid_taps(h, w):
    """Tap-positions of the ``[2h-1, 2w-1]`` output that read the ``[h, w]``
    source grid; taps on the zero halo need no work. Phase ``ee`` covers h x w
    source positions, an odd row or column phase one fewer."""
    from zdcsim_torch.ops import decode_kernels as dk

    n = 0
    for name in dk._PHASES:
        rows = h if name[0] == "e" else h - 1
        cols = w if name[1] == "e" else w - 1
        for dr, dc in dk._PHASE_OFFSETS[name]:
            n += (sum(0 <= i + dr < h for i in range(rows))
                  * sum(0 <= j + dc < w for j in range(cols)))
    return n


def time_kernels(a_in, b_in, launches, errs, card):
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    y, scale, bias = a_in
    y = y[:TIME_ROWS].contiguous()
    rows, f = y.shape
    a_ms = time_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_plain = time_ms(lambda: dk.ln_leaky_rowquant_plain(y, scale, bias), 10)
    a_bytes = rows * f * 2 + 2 * f * 4 + rows * f + rows * 4
    a_ops = rows * f * 13  # mean 1, variance 3, normalise+affine 4, leaky 1, amax 1, quantise 3
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_ops / F32_OPS_PER_S) * 1e3

    xq, sx, kq, sk, cbias = b_in
    nb, h, w, cin = xq.shape
    cout = kq.shape[2]
    b_ms = time_ms(lambda: dk.up2_conv4_int8(xq, sx, kq, sk, cbias, torch.bfloat16), 20)
    b_plain = time_ms(lambda: dk.up2_conv4_int8_plain(xq, sx, kq, sk, cbias, torch.bfloat16), 3)
    b_ops = 2 * nb * in_grid_taps(h, w) * cin * cout
    b_bytes = (xq.numel() + nb * 4 + kq.numel() + sk.numel() * 4 + cout * 4
               + nb * (2 * h - 1) * (2 * w - 1) * cout * 2)
    b_bound = max(b_bytes / HBM_BYTES_PER_S, b_ops / INT8_OPS_PER_S) * 1e3

    rec = [
        {"name": "ln_leaky_rowquant", "route": "cuda",
         "source": "zdcsim_torch/csrc/ln_leaky_rowquant.cu",
         "replaces": "zdcsim/ops/pallas_decode.py:74",
         "launches": launches["ln_leaky_rowquant"], "max_abs_err": errs[0],
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": "bytes" if a_bytes / HBM_BYTES_PER_S >= a_ops / F32_OPS_PER_S else "operations",
         "library_ms": None},
        {"name": "up2_conv4_int8", "route": "cuda",
         "source": "zdcsim_torch/csrc/up2_conv4_int8.cu",
         "replaces": "zdcsim/ops/pallas_decode.py:211",
         "launches": launches["up2_conv4_int8"], "max_abs_err": errs[1],
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": "bytes" if b_bytes / HBM_BYTES_PER_S >= b_ops / INT8_OPS_PER_S else "operations",
         "library_ms": None},
    ]
    for r in rec:
        log("6 kernel times", f"{r['name']} at {TIME_ROWS} rows: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, {r['launches']} launches per "
            f"{N_SHOWERS} showers [{card}]")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-5 on the CPU at batch 8 with the plain versions")
    ap.add_argument("--profile", action="store_true",
                    help="profile one serve on the card with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    rehearse = args.rehearse_cpu
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    from zdcsim_torch.ops import _build
    from zdcsim_torch.utils.artifact import load_serving_artifact

    if rehearse:
        dev, card = torch.device("cpu"), "cpu rehearsal"
    else:
        dev = torch.device("cuda")
        card = card_line()
        log("1 card", f"torch.cuda.get_device_name(0)={torch.cuda.get_device_name(0)!r} "
            f"device_count={torch.cuda.device_count()} torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
        print(f"card: {card}", flush=True)
        t = time.perf_counter()
        lib_path, build_log = _build.build()
        _build.library()
        log("2 build", f"{time.perf_counter() - t:.2f}s -> {os.path.relpath(lib_path, HERE)}")
        for line in build_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  " + line.strip(), flush=True)

    rng = np.random.default_rng(args.seed)
    gp, _, rp, _ = load_serving_artifact(TEACHER)
    log("3 kernel A", "teacher artifact loaded")
    a_in = check_kernel_a(gp, rng, dev, 8 if rehearse else A_ROWS)
    b_in = check_kernel_b(gp, rng, dev, 8 if rehearse else B_ROWS)
    if rehearse:
        serve(gp, rp, rng, dev, 24, 8, 2, card, args.seed)
        print(json.dumps({"rehearsal": True}), flush=True)
        return 0
    launches = serve(gp, rp, rng, dev, N_SHOWERS, SERVE_BATCH, SERVE_TILE, card, args.seed,
                     args.profile)
    rec = time_kernels(a_in[:3], b_in[:5], launches, (a_in[3], b_in[5]), card)
    log("done", f"wall {time.perf_counter() - T0:.2f}s [{card}]")
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
