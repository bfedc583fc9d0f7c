#!/usr/bin/env python3
"""Smoke run of the zdcsim_torch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse-cpu  # phases 3-8 on the CPU at small sizes
    python3 chip_smoke.py --profile       # adds a profile of each kernel path's serve

Phases, each printing lines with the elapsed seconds:

1. the card: name, device count and ``nvidia-smi`` name / power limit;
2. the build of the CUDA kernels (seconds, ptxas register/smem report);
3. kernel A (LN + leaky + int8) against its plain version at [256, 92160];
4. kernel B (up2 + conv4 int8) against its plain version at [64, 18, 10, 512];
5. kernel C (GN + leaky + int8) against its plain version at [64, 35, 19, 256]
   with the teacher's GroupNorm2d_0 parameters;
6. kernel D (row-resize conv4 int8) against its plain version at
   [64, 35, 30, 256] with the teacher's Conv_1 weights;
7. the plain int8 conv (``_conv_i8``, int32 sums) against an int64 direct
   sum at Conv_1's and Conv_2's shapes;
8. serving the full-width proton teacher's generator
   (artifacts/gate/gate_serving_weights.npz): 16384 showers through
   ``FastSim(precision="int8")`` (the yardstick), then through each kernel
   path, ``"int8_pallas_ab"`` (kernels A, B) and ``"int8_pallas"`` (A, B, C,
   D): launch counts of each path's kernels (set to 0 just before the path
   runs, read just after; each must be > 0), output checks, agreement with
   ``"int8"``, rate and peak memory of all three. The teacher's router
   sends every condition to expert 1, so the serve routes with a router
   drawn from ``--seed`` and fails unless every expert decodes showers;
9. kernel times with CUDA events at the serving tile (64 rows).

``--profile`` adds a ``torch.profiler`` trace of one serve of 16384 showers
on each kernel path (printed as a table, not written to disk): device time
per kernel and the device's idle share of the serve's wall time.

The line before the last is the kernels' JSON record, with the launches of
the ``int8_pallas`` serve (the path that runs all four kernels); the last
line is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line is printed. Without a CUDA device the script exits with
code 2 and prints no result; ``--rehearse-cpu`` ends with
``{"rehearsal": true}``.
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
A_ROWS, B_ROWS, C_ROWS, D_ROWS, TIME_ROWS = 256, 64, 64, 64, 64
KERNEL_PATHS = {  # precision -> the kernels its decode launches
    "int8_pallas_ab": ("ln_leaky_rowquant", "up2_conv4_int8"),
    "int8_pallas": ("ln_leaky_rowquant", "up2_conv4_int8", "gn_leaky_rowquant",
                    "row_resize_conv4_int8"),
}
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


def check_kernel_c(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    gn = gp["GroupNorm2d_0"]["GroupNorm_0"]
    scale = torch.as_tensor(gn["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(gn["bias"][0]).to(dev, torch.bfloat16).float()
    c = scale.shape[0]
    x = torch.as_tensor(rng.standard_normal((rows, 35, 19, c), dtype="float32") * 2.0
                        + 0.5).to(dev, torch.bfloat16)
    q, s = dk.gn_leaky_rowquant(x, scale, bias)
    qp, sp = dk.gn_leaky_rowquant_plain(x, scale, bias)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    log("5 kernel C", f"[{rows}, 35, 19, {c}] bf16: max s rel err {s_rel:.3e} (rtol 1e-5), "
        f"max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%)")
    if not (s_rel <= 1e-5 and q_max <= 1 and flips < 0.01):
        fail("kernel C disagrees with its plain version")
    return x[:TIME_ROWS], scale, bias, float(q_max)


def check_kernel_d(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.models.proton_fast import _row_phase_plan
    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_1"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    kq, sk, offsets = dk._quant_row_phases(kernel, _row_phase_plan(35, 56, 4, 1)[2])
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 35, 30, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        out = dk.row_resize_conv4_int8(xq, sx, kq, sk, offsets, bias, 56, out_dtype=dt)
        ref = dk.row_resize_conv4_int8_plain(xq, sx, kq, sk, offsets, bias, 56, out_dtype=dt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        errs.append((out.float() - ref.float()).abs().max().item())
    log("6 kernel D", f"[{rows}, 35, 30, {cin}] -> {tuple(out.shape)}: max abs err f32 "
        f"{errs[0]:.3e}, bf16 {errs[1]:.3e} (both must be 0)")
    if max(errs) != 0.0:
        fail("kernel D disagrees with its plain version")
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kq, sk, offsets, bias, errs[0]


def conv_int64(xq, kq, pad):
    """Direct int64 sum of an NHWC x HWIO int8 conv, on the host's CPU (an
    independent reference: int64 products and sums, one matmul per tap)."""
    import torch
    import torch.nn.functional as F

    b, h, w, cin = xq.shape
    kh, kw, _, cout = kq.shape
    xp = F.pad(xq.cpu().to(torch.int64), (0, 0, pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    ho, wo = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    k64 = kq.cpu().to(torch.int64)
    out = torch.zeros((b * ho * wo, cout), dtype=torch.int64)
    for a in range(kh):
        for c in range(kw):
            out += xp[:, a:a + ho, c:c + wo].reshape(-1, cin) @ k64[a, c]
    return out.reshape(b, ho, wo, cout)


def check_conv_i8(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.models import proton_fast as pf

    for name, (h, w) in (("Conv_1", (56, 30)), ("Conv_2", (55, 29))):
        kernel = torch.as_tensor(gp[name]["kernel"][0]).to(dev, torch.bfloat16)
        kq, _ = pf._quant_per_cout(kernel)
        xq = torch.as_tensor(rng.integers(-127, 128, (rows, h, w, kq.shape[2]),
                                          dtype="int8")).to(dev)
        out = pf._conv_i8(xq, kq, ((1, 1), (1, 1)))
        ref = conv_int64(xq, kq, ((1, 1), (1, 1)))
        same = out.dtype == torch.int32 and torch.equal(out.cpu().to(torch.int64), ref)
        log("7 conv_i8", f"{name} [{rows}, {h}, {w}, {kq.shape[2]}] x {tuple(kq.shape)} -> "
            f"{tuple(out.shape)} int32 on {dev.type}: equal to the int64 direct sum {same} "
            f"(max |sum| {ref.abs().max().item()})")
        if not same:
            fail(f"_conv_i8 differs from the int64 direct sum at {name}")


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


def serve_rate(eng, dev, n, batch, tile, card, seed, precision):
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = eng.throughput_bulk(n_showers=n, generator=gen)
    peak = torch.cuda.max_memory_allocated(dev)
    log("8 serve", f"{precision} throughput_bulk: {stats['showers_per_sec']:.1f} showers/s "
        f"({n} showers in {stats['seconds']:.3f}s, batch {batch}, tile {tile}); "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def serve(gp, rp, rng, dev, n, batch, tile, card, seed, profile=False):
    """The yardstick ``int8`` serve, then each kernel path; returns the
    launch counts of each path's main run."""
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
    log("8 serve", f"the teacher's router sends these conditions to experts "
        f"{torch.bincount(t_ids, minlength=3).tolist()}; serving with a router drawn from --seed")
    router = seeded_router(rng)

    eng8 = FastSim(gp, router, batch_size=batch, precision="int8", device=dev)
    eng8._build_switch(tile=tile)
    t = time.perf_counter()
    imgs8, ids8 = eng8.simulate_bulk(cond, noise=noise, return_experts=True)
    imgs8, ids8 = imgs8.cpu().numpy(), ids8.cpu().numpy()
    log("8 serve", f"int8 (plain int32 convs): {n} showers in {time.perf_counter() - t:.3f}s")
    if dev.type == "cuda":
        serve_rate(eng8, dev, n, batch, tile, card, seed, "int8")
    del eng8
    b = np.log1p(imgs8.sum(axis=(1, 2)))

    wrappers = {name: getattr(dk, name) for name in KERNEL_PATHS["int8_pallas"]}
    launches = {}
    for precision, names in KERNEL_PATHS.items():
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev)
        eng._build_switch(tile=tile)
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_main = time.perf_counter() - t
        counts = {name: w.launches for name, w in wrappers.items()}
        launches[precision] = counts
        used = torch.bincount(ids, minlength=3).tolist()
        log("8 serve", f"{precision} main path: {n} showers, batch {batch}, tile {tile} in "
            f"{t_main:.3f}s; kernel launches {counts}; showers per expert {used}")
        if dev.type == "cuda" and min(counts[k] for k in names) <= 0:
            fail(f"the {precision} path did not launch each of its kernels {names}: {counts}")
        if min(used) <= 0:
            fail(f"the serve did not decode with every expert: {used}")
        imgs_np, ids_np = imgs.cpu().numpy(), ids.cpu().numpy()
        if imgs_np.shape != (n, 56, 30) or not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
            fail(f"{precision}: served showers not finite/non-negative of shape ({n}, 56, 30)")
        log("8 serve", f"{precision} output {imgs_np.shape} finite and >= 0 (min "
            f"{imgs_np.min():.3e}, max {imgs_np.max():.3e})")
        a = np.log1p(imgs_np.sum(axis=(1, 2)))
        rel = np.abs(a - b) / np.abs(b)
        same_ids = bool((ids_np == ids8).all())
        per_expert = [float(rel[ids8 == e].max()) for e in range(3)]
        log("8 serve", f"{precision} vs precision='int8': routing ids identical {same_ids}; "
            f"max rel diff of per-shower log1p sums {rel.max():.4f} (rtol 0.15), "
            f"per expert {[round(x, 4) for x in per_expert]}")
        if not same_ids or rel.max() > 0.15:
            fail(f"{precision} and int8 serving disagree")
        if dev.type == "cuda":
            serve_rate(eng, dev, n, batch, tile, card, seed, precision)
            if profile:
                profile_serve(eng, cond, noise, card, precision)
        del eng
    return launches


def profile_serve(eng, cond, noise, card, precision):
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
    log("profile", f"{precision} serve of {cond.shape[0]} showers: wall {wall_us / 1e3:.1f} ms, device busy "
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


def row_resize_taps(h, w, n_resized_rows):
    """(Row-group, column) tap-positions of kernel D's ``[n_resized_rows - 1,
    w]`` output that read the ``[h, w]`` source grid: each phase's merged
    row groups (not the zero-padded one) x the 4 column taps."""
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    _, p_num, plans = _row_phase_plan(h, n_resized_rows, 4, 1)
    rows = sum(0 <= p_num * r + d < h
               for _, groups, n_phase in plans for r in range(n_phase) for d, _ in groups)
    return rows * sum(0 <= j + t - 1 < w for j in range(w) for t in range(4))


def bound(n_bytes, n_ops, ops_per_s):
    """``(bound in ms, what bounds it)``: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(a_in, b_in, c_in, d_in, launches, errs, card):
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    y, scale, bias = a_in
    y = y[:TIME_ROWS].contiguous()
    rows, f = y.shape
    a_ms = time_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_plain = time_ms(lambda: dk.ln_leaky_rowquant_plain(y, scale, bias), 10)
    a_bytes = rows * f * 2 + 2 * f * 4 + rows * f + rows * 4
    a_ops = rows * f * 13  # mean 1, variance 3, normalise+affine 4, leaky 1, amax 1, quantise 3

    xq, sx, kq, sk, cbias = b_in
    nb, h, w, cin = xq.shape
    cout = kq.shape[2]
    b_ms = time_ms(lambda: dk.up2_conv4_int8(xq, sx, kq, sk, cbias, torch.bfloat16), 20)
    b_plain = time_ms(lambda: dk.up2_conv4_int8_plain(xq, sx, kq, sk, cbias, torch.bfloat16), 3)
    b_ops = 2 * nb * in_grid_taps(h, w) * cin * cout
    b_bytes = (xq.numel() + nb * 4 + kq.numel() + sk.numel() * 4 + cout * 4
               + nb * (2 * h - 1) * (2 * w - 1) * cout * 2)

    x, gscale, gbias = c_in
    x = x.contiguous()
    c_ms = time_ms(lambda: dk.gn_leaky_rowquant(x, gscale, gbias), 50)
    c_plain = time_ms(lambda: dk.gn_leaky_rowquant_plain(x, gscale, gbias), 10)
    c_bytes = x.numel() * 2 + 2 * x.shape[-1] * 4 + x.numel() + x.shape[0] * 4
    c_ops = x.numel() * 13  # sums 3, normalise+affine 4, leaky 1, amax 1, quantise 3, +1 rounding

    dq, dsx, dkq, dsk, offsets, dbias = d_in
    dq = dq.contiguous()
    nd, hd, wd, dcin = dq.shape
    dcout = dkq.shape[3]
    d_ms = time_ms(lambda: dk.row_resize_conv4_int8(dq, dsx, dkq, dsk, offsets, dbias, 56,
                                                    torch.bfloat16), 20)
    d_plain = time_ms(lambda: dk.row_resize_conv4_int8_plain(dq, dsx, dkq, dsk, offsets, dbias,
                                                             56, torch.bfloat16), 3)
    d_ops = 2 * nd * row_resize_taps(hd, wd, 56) * dcin * dcout
    d_bytes = (dq.numel() + nd * 4 + dkq.numel() + dsk.numel() * 4 + dcout * 4
               + nd * 55 * wd * dcout * 2)

    rec = []
    for name, src, replaces, ms, plain, n_bytes, n_ops, peak, err in (
        ("ln_leaky_rowquant", "ln_leaky_rowquant.cu", "zdcsim/ops/pallas_decode.py:74",
         a_ms, a_plain, a_bytes, a_ops, F32_OPS_PER_S, errs[0]),
        ("up2_conv4_int8", "up2_conv4_int8.cu", "zdcsim/ops/pallas_decode.py:211",
         b_ms, b_plain, b_bytes, b_ops, INT8_OPS_PER_S, errs[1]),
        ("gn_leaky_rowquant", "gn_leaky_rowquant.cu", "zdcsim/ops/pallas_decode.py:308",
         c_ms, c_plain, c_bytes, c_ops, F32_OPS_PER_S, errs[2]),
        ("row_resize_conv4_int8", "row_resize_conv4_int8.cu", "zdcsim/ops/pallas_decode.py:463",
         d_ms, d_plain, d_bytes, d_ops, INT8_OPS_PER_S, errs[3]),
    ):
        bound_ms, bound_by = bound(n_bytes, n_ops, peak)
        rec.append({"name": name, "route": "cuda", "source": f"zdcsim_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None})
    for r in rec:
        log("9 kernel times", f"{r['name']} at {TIME_ROWS} rows: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, {r['launches']} launches per "
            f"{N_SHOWERS} showers on the int8_pallas path [{card}]")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-8 on the CPU at small sizes with the plain versions")
    ap.add_argument("--profile", action="store_true",
                    help="profile one serve of each kernel path with torch.profiler")
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
    # the later checks draw from a stream of their own, so the serve's
    # conditions and router stay those that phases 3-4 leave
    rng_cd = np.random.default_rng([args.seed, 1])
    c_in = check_kernel_c(gp, rng_cd, dev, 4 if rehearse else C_ROWS)
    d_in = check_kernel_d(gp, rng_cd, dev, 4 if rehearse else D_ROWS)
    check_conv_i8(gp, rng_cd, dev, 1 if rehearse else 2)
    if rehearse:
        serve(gp, rp, rng, dev, 24, 8, 2, card, args.seed)
        print(json.dumps({"rehearsal": True}), flush=True)
        return 0
    launches = serve(gp, rp, rng, dev, N_SHOWERS, SERVE_BATCH, SERVE_TILE, card, args.seed,
                     args.profile)
    rec = time_kernels(a_in[:3], b_in[:5], c_in[:3], d_in[:6], launches["int8_pallas"],
                       (a_in[3], b_in[5], c_in[3], d_in[6]), card)
    log("done", f"wall {time.perf_counter() - T0:.2f}s [{card}]")
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
