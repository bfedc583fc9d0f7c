#!/usr/bin/env python3
"""Smoke run of the zdcsim_torch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse-cpu  # phases 3-13 on the CPU at small sizes
    python3 chip_smoke.py --profile       # adds a profile of each kernel path's serve

Phases, each printing lines with the elapsed seconds:

1. the card: name, device count and ``nvidia-smi`` name / power limit;
2. the build of the CUDA kernels (seconds, ptxas register/smem report), and
   from ``cuobjdump -sass`` of the built library, where the toolkit has it,
   the count of int8 tensor-core (``IMMA``, ``IGMMA``) and ``IDP4A``
   instructions in each instantiation of the shared conv kernel
   (``conv_mma.cuh``: two in G's and H's source, four each in B's and D's,
   f32 and bf16 epilogues) and in B's and D's ``__dp4a`` bodies: it fails
   unless every ``conv_mma_kernel`` has ``IGMMA`` and no ``IMMA`` or
   ``IDP4A``;
3. kernel A (LN + leaky + int8) against its plain version at [256, 92160]
   and at the w=0.125 student's [256, 11520] (from a seeded stream of its
   own), each launched twice: the rerun bit-identical, both launches in
   thread-block clusters of the launch plan's k (``cluster_launches``);
   and bit for bit equal to an IEEE float32 numpy reference at [64, 92160]
   on inputs whose sums are exact in any order (pairs of small integers
   +v, -v), which holds its quantise pass's division to IEEE's;
4. kernel B (up2 + conv4 int8) against its plain version, bit for bit in f32
   and bf16, at [64, 18, 10, 512] -> 256 with the teacher's Conv_0 weights
   (on the int8 tensor cores) and at a narrow [4, 5, 3, 36] -> 70 (its
   ``__dp4a`` body);
5. kernel C (GN + leaky + int8) against its plain version at [64, 35, 19, 256]
   with the teacher's GroupNorm2d_0 parameters and at the student's
   [64, 35, 19, 32] (a stream of its own), checked as A is, and bit for
   bit on small-integer inputs at [64, 35, 19, 256];
6. kernel D (row-resize conv4 int8) against its plain version, bit for bit
   in f32 and bf16, at [64, 35, 30, 256] -> 128 with the teacher's Conv_1
   weights (on the tensor cores) and at a narrow [4, 35, 30, 32] -> 32;
7. the plain int8 conv (``_conv_i8``, int32 sums) against an int64 direct
   sum at Conv_1's and Conv_2's shapes;
7b. kernels G (fused decode front) and H (whole fused decode) against their
   plain versions at [64, 92160]: the Dense_1 output of the teacher's
   expert 1 (bf16, as the engine holds it) on seeded noise and conditions,
   with that expert's weights; H also with ``apply_expm1``; then each of
   the three int8 convs that G and H launch (``fused_conv_int8``: Conv_0's
   parity phases, Conv_1, Conv_2) on that path's own activations, equal to
   its plain version bit for bit;
8. serving the full-width proton teacher's generator
   (artifacts/gate/gate_serving_weights.npz): 16384 showers through
   ``FastSim(precision="int8")`` (the yardstick), then through each kernel
   path, ``"int8_pallas_ab"`` (kernels A, B), ``"int8_pallas"`` (A, B, C,
   D), ``"int8_fused_front"`` (G) and ``"int8_fused"`` (H): launch counts of
   each path's kernels (set to 0 just before the path runs, read just after;
   each must be > 0, every launch of B and D on the tensor cores, and
   every launch of A and C in clusters of its plan's k),
   output checks, agreement with ``"int8"``, rate and peak memory of every
   path. The teacher's router sends every condition to
   expert 1, so the serve routes with a router drawn from ``--seed`` and
   fails unless every expert decodes showers;
9. kernel times with CUDA events at the serving tile (64 rows); A and C
   replayed in a CUDA graph (they take less time on the card than one
   launch through the host), beside the host loop's time, and at
   each cluster size k of 1, 2, 4, 8 and 1, 7 and 64 rows, beside
   ``cudaOccupancyMaxActiveClusters`` (the sweep that chose the plan); B and D
   beside, as a yardstick the port never calls, ``torch._int_mm`` on pre-built
   [M, K] x [K, N] matrices of the same GEMM shapes (no im2col); beside G
   and H, the ported chains that compute the same functions: kernels A -> B
   (f32 out) -> C -> the resize gather, and the ``int8_pallas`` decode after
   the MLP; each of G's and H's three convs beside its int8 bound and
   ``torch._int_mm`` likewise;
10. the fidelity gate's test split (25600 synthetic events, seed 7, numpy),
    and kernel E (expm1 + channel sums) against its plain version (rtol
    1e-5) on its 5120 real showers [5120, 56, 30] in f32 and in bf16 and on
    a [37, 44, 44] f32 batch, each launch on the bulk ring
    (``bulk_launches``);
11. kernel F (routed expm1 + channel sums) on the teacher's all-expert
    log-space decode of 4096 showers [3, 4096, 56, 30], routed by phase 8's
    seeded router (launches counted over this path): against its plain
    version (rtol 1e-5), bit-equal to kernel E on the routed rows, both on
    the bulk ring;
12. ``f32`` and ``bf16`` serves of 4096 teacher showers against ``int8`` on
    the same inputs (routing identical, per-shower log1p sums within rtol
    0.15), with rate and peak memory;
13. the fidelity gate (``fidelity_torch.run_gate``, three noise draws) on
    the teacher at ``int8``, ``int8_pallas`` and ``int8_fused`` and on the
    w=0.125 student at ``int8``: each record, its kernel launches (counts set to 0 just
    before each gate), and a failure unless its value is finite,
    ``vs_baseline >= 1.0`` and every launch of E on the bulk ring; the
    floor is printed beside the CPU tests' anchor;
14. kernels E and F at [16384, 56, 30] in f32 and bf16 (E also at the
    gate's 5120 showers): replayed in a CUDA graph, beside the host loop's
    time, the direct body (one warp a shower reading device memory itself)
    forced on the same input (``_direct_body``, graph replayed), their
    plain versions, PyTorch's ``expm1`` then the channel-basis matmul, and
    the bound; each graph's replays, the ``GRAPH_WARM`` untimed ones first,
    and E at f32 timed again after the other cases.

``--profile`` adds a ``torch.profiler`` trace of one serve of 16384 showers
on each kernel path (printed as a table, not written to disk): device time
of the 15 costliest kernels and of every kernel of the port below them,
and the device's idle share of the serve's wall time.

The line before the last is the kernels' JSON record, with the launches of
the ``int8_pallas`` serve (the path that runs A-D), of the teacher's
``int8`` gate (E), of the all-expert path (F) and of the ``int8_fused_front``
(G) and ``int8_fused`` (H) serves, A's and C's ``k_sweep`` and
``eager_ms`` (the host loop's time), B's and D's
``int_mm_ms``, G's and H's ``conv_ms`` (their convs' times), and E's and
F's ``body``, ``bulk_launches``, ``graph_ms``, ``old_body_ms`` and
``cases`` (every shape and dtype of phase 14; ``ms`` is ``graph_ms``); the
last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line is printed. Without a CUDA device the script exits with code 2
and prints no result. ``--rehearse-cpu`` runs at the sizes of
``REHEARSE_*`` below, each cut to what its phase needs to check what it
checks: D at 2 rows, G and H at [1, 92160], a serve of 7 showers in one
batch of 8 at tile 2 (the router drawn after their conditions sends them to
every expert; at 6 it leaves one out), the gate's split of 2560 synthetic
events with E at [8, 56, 30], F's all-expert decode of 7 showers (the first
count at which that router reads every expert), float serves of 2
showers, and the student's gate on the first 128 test conditions in one
chunk with one draw. Both modes print each phase's seconds on one line
before the last; the rehearsal ends with
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
STUDENT = os.path.join(HERE, "artifacts", "gate", "student_w0.125_serving_weights.npz")
FLOOR_ANCHOR = 457.4265  # the floor of the full split on the CPU (tests/test_torch_data.py)
N_SHOWERS = 16384
F_SHOWERS = FLOAT_SHOWERS = 4096
EF_TIME_ROWS = 16384
GRAPH_WARM = 5  # untimed replays of a timed graph: at least so many
GRAPH_WARM_MS = 100  # and at least so much card time
# --rehearse-cpu sizes (see the module doc)
REHEARSE_SERVE = (7, 8, 2)  # showers, batch, tile
REHEARSE_SPLIT = 2560  # synthetic events of the gate's split: 512 test showers
REHEARSE_F = 7
REHEARSE_FLOAT = (2, 2, 2)
REHEARSE_GATE = 128  # test conditions, one chunk
SERVE_BATCH, SERVE_TILE = 4096, 64  # bench.py's teacher ladder tile
A_ROWS, B_ROWS, C_ROWS, D_ROWS, GH_ROWS, TIME_ROWS = 256, 64, 64, 64, 64, 64
STUDENT_F, STUDENT_C = 11520, 32  # the w=0.125 student's Dense_1 and GroupNorm2d_0 widths
SWEEP_ROWS = (1, 7, 64)  # phase 9's cluster-size sweep of A and C
KERNEL_PATHS = {  # precision -> the kernels its decode launches
    "int8_pallas_ab": ("ln_leaky_rowquant", "up2_conv4_int8"),
    "int8_pallas": ("ln_leaky_rowquant", "up2_conv4_int8", "gn_leaky_rowquant",
                    "row_resize_conv4_int8"),
    "int8_fused_front": ("fused_decode_front",),
    "int8_fused": ("fused_decode",),
}
# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

T0 = time.perf_counter()
PHASE_S = {}  # phase -> seconds, printed on one line at the end


def timed(phase: str, fn, *args, **kwargs):
    """Run one phase, adding its wall time to :data:`PHASE_S`."""
    t = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + time.perf_counter() - t


def log_phase_times() -> None:
    log("phase times", ", ".join(f"{k} {v:.2f}s" for k, v in PHASE_S.items())
        + f"; wall {time.perf_counter() - T0:.2f}s")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] t={time.perf_counter() - T0:.2f}s {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line(query: str = "name,power.limit") -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi printed no card")
    return out.splitlines()[0].strip()


def kernel_wrappers():
    """Every kernel wrapper of the port by name; each counts its launches."""
    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    return {
        **{name: getattr(dk, name) for name in KERNEL_PATHS["int8_pallas"]},
        "fused_decode_front": fdk.fused_decode_front, "fused_decode": fdk.fused_decode,
        "expm1_channel_sums": ek.expm1_channel_sums,
        "routed_expm1_channel_sums": ek.routed_expm1_channel_sums,
    }


SUB_COUNTS = {"mma_launches": "on conv_mma", "cluster_launches": "on clusters",
              "bulk_launches": "on the bulk ring"}


def reset_counts(wrappers):
    """Set every launch count to 0 (B's and D's tensor-core counts, A's and
    C's cluster counts and E's and F's bulk-ring counts too)."""
    for w in wrappers.values():
        w.launches = 0
        for attr in SUB_COUNTS:
            if hasattr(w, attr):
                setattr(w, attr, 0)


def read_counts(wrappers):
    """``{name: launches}``, with ``{name + " on conv_mma": n}`` for B and D,
    ``{name + " on clusters": n}`` for A and C (launches in clusters of the
    plan's k) and ``{name + " on the bulk ring": n}`` for E and F."""
    counts = {name: w.launches for name, w in wrappers.items()}
    for attr, label in SUB_COUNTS.items():
        counts.update({f"{name} {label}": getattr(w, attr) for name, w in wrappers.items()
                       if hasattr(w, attr)})
    return counts


def check_conv_equal(phase, what, fn, plain, args, dev, mma):
    """Kernel B or D (``fn``) against its plain version on ``args``, bit for
    bit in f32 and bf16, and on the tensor cores exactly when ``mma``.
    Returns the largest absolute difference (0)."""
    import torch

    n0 = fn.mma_launches
    errs, same = [], True
    for dt in (torch.float32, torch.bfloat16):
        out, ref = fn(*args, out_dtype=dt), plain(*args, out_dtype=dt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = same and out.shape == ref.shape and torch.equal(out, ref)
        errs.append((out.float() - ref.float()).abs().max().item())
    on_mma = dev.type == "cuda" and fn.mma_launches == n0 + 2
    body = "int8 tensor cores" if mma else "__dp4a body"
    ran = body if dev.type == "cuda" else f"plain version on the CPU; the card runs the {body}"
    log(phase, f"{what} -> {tuple(out.shape)} ({ran}): equal to its plain version {same} "
        f"(max abs err f32 {errs[0]:.3e}, bf16 {errs[1]:.3e})")
    if not same:
        fail(f"{what} disagrees with its plain version")
    if dev.type == "cuda" and on_mma != mma:
        fail(f"{what} ran on the {'__dp4a body' if mma else 'tensor cores'}, not the {body}")
    return max(errs)


def narrow_conv_inputs(rng, rows, h, w, cin, cout, dev):
    """Seeded int8 activations, a random 4x4 kernel (f32), sx and bias at a
    narrow width (a student's, on the ``__dp4a`` bodies)."""
    import torch

    xq = torch.as_tensor(rng.integers(-127, 128, (rows, h, w, cin), dtype="int8")).to(dev)
    kernel = torch.as_tensor(rng.standard_normal((4, 4, cin, cout), dtype="float32") * 0.1).to(dev)
    sx = torch.as_tensor((abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")).to(dev)
    bias = torch.as_tensor(rng.standard_normal(cout, dtype="float32")).to(dev)
    return xq, kernel, sx, bias


def norm_sample(x):
    """``(kind, sample)`` of :func:`norm_quant_plan` for kernel A's ``[B, F]``
    or kernel C's ``[B, H, W, C]`` input."""
    if x.ndim == 2:
        return "ln", (x.shape[1],)
    return "gn", (x.shape[1] * x.shape[2], x.shape[3])


def check_norm_quant(phase, what, fn, plain, args, s_rtol, dev):
    """Kernel A or C (``fn``) against its plain version on ``args``: s within
    ``s_rtol``, |q - q_plain| <= 1 with flips under 1%; a second launch
    bit-identical to the first; on the card, both launches in clusters of
    the plan's k. Returns the largest |q - q_plain|."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    n0, c0 = fn.launches, fn.cluster_launches
    q, s = fn(*args)
    q2, s2 = fn(*args)
    qp, sp = plain(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    rerun = torch.equal(q, q2) and torch.equal(s, s2)
    n, nc = fn.launches - n0, fn.cluster_launches - c0
    x = args[0]
    kind, sample = norm_sample(x)
    plan = dk.norm_quant_plan(kind, x.shape[0], sample, x.element_size())
    log(phase, f"{what} {str(x.dtype)[6:]}: max s rel err {s_rel:.3e} (rtol {s_rtol:g}), "
        f"max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%); rerun bit-identical "
        f"{rerun}; {nc} of {n} launches in clusters of the plan's k={plan.k} ({plan.threads} "
        f"threads, {plan.smem} B shared, share {'kept' if plan.kept else 'streamed'})")
    if not (s_rel <= s_rtol and q_max <= 1 and flips < 0.01 and rerun):
        fail(f"{fn.__name__} {what} disagrees with its plain version or with its rerun")
    if dev.type == "cuda" and (n != 2 or nc != 2):
        fail(f"{fn.__name__} {what}: {nc} of {n} launches in clusters of the plan's k")
    return float(q_max)


def exact_sum_inputs(rng, shape, dev):
    """bf16 small integers, each row of A's ``[B, F]`` made of pairs +v, -v:
    every sum of A's and C's statistics is exact in any order."""
    import numpy as np
    import torch

    if len(shape) == 2:
        half = rng.integers(-8, 9, size=(shape[0], shape[1] // 2))
        vals = rng.permuted(np.concatenate([half, -half], axis=1), axis=1)
    else:
        vals = rng.integers(-8, 9, size=shape)
    return torch.as_tensor(vals.astype(np.float32)).to(dev, torch.bfloat16)


def ieee_norm_quant(kind, x, scale, bias, groups=32):
    """Kernel A's or C's function in numpy float32, each operation rounded
    once as IEEE says (numpy's ``sqrt`` and ``/`` are; torch's CPU ``sqrt``
    is not always): the reference on exact-sum inputs."""
    import numpy as np

    x = x.float().cpu().numpy()
    scale, bias = scale.cpu().numpy(), bias.cpu().numpy()
    b = x.shape[0]
    if kind == "ln":
        n = np.float32(x.shape[1])
        d = x - x.sum(1, keepdims=True, dtype=np.float32) / n
        rstd = np.float32(1) / np.sqrt((d * d).sum(1, keepdims=True, dtype=np.float32) / n
                                       + np.float32(1e-6))
        z = d * rstd * scale + bias
    else:
        _, h, w, c = x.shape
        xg = x.reshape(b, h * w, groups, c // groups)
        n = np.float32(h * w * (c // groups))
        mu = xg.sum((1, 3), dtype=np.float32) / n
        var = np.maximum((xg * xg).sum((1, 3), dtype=np.float32) / n - mu * mu, np.float32(0))
        rstd = np.float32(1) / np.sqrt(var + np.float32(1e-6))
        z = ((xg - mu[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape) * scale + bias
    z = np.where(z >= 0, z, np.float32(0.1) * z).reshape(b, -1)
    s = np.maximum(np.abs(z).max(1, keepdims=True) / np.float32(127), np.float32(1e-12))
    return np.clip(np.round(z / s), -127, 127).astype(np.int8), s


def check_exact(phase, fn, args):
    """Kernel A or C on exact-sum inputs against :func:`ieee_norm_quant`: q
    and s bit for bit, which holds every rounding step, the quantise pass's
    division among them, to IEEE's."""
    import numpy as np

    x = args[0]
    q, s = fn(*args)
    q_ref, s_ref = ieee_norm_quant("ln" if x.ndim == 2 else "gn", *args)
    same = (np.array_equal(q.cpu().numpy().reshape(q_ref.shape), q_ref)
            and np.array_equal(s.cpu().numpy(), s_ref))
    log(phase, f"exact-sum {list(x.shape)} {str(x.dtype)[6:]}: equal to the IEEE float32 "
        f"reference bit for bit {same}")
    if not same:
        fail(f"{fn.__name__} differs from the IEEE float32 reference on exact-sum inputs")


def check_kernel_a(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    # as the engine holds them: bf16 weights, cast to f32 by quantize_weights
    ln = gp["MLPBlock_1"]["LayerNorm_0"]
    scale = torch.as_tensor(ln["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(ln["bias"][0]).to(dev, torch.bfloat16).float()
    f = scale.shape[0]
    y = torch.as_tensor(rng.standard_normal((rows, f), dtype="float32") * 3.0).to(dev, torch.bfloat16)
    q_max = check_norm_quant("3 kernel A", f"[{rows}, {f}]", dk.ln_leaky_rowquant,
                             dk.ln_leaky_rowquant_plain, (y, scale, bias), 1e-6, dev)
    # the w=0.125 student's width, from a stream of its own, so that the
    # serve's conditions and router do not change
    srng = np.random.default_rng([seed, 3])
    sf = STUDENT_F
    ys = torch.as_tensor(srng.standard_normal((rows, sf), dtype="float32") * 3.0).to(dev, torch.bfloat16)
    ss = torch.as_tensor(srng.standard_normal(sf, dtype="float32") * 0.5 + 1.0).to(dev)
    bs = torch.as_tensor(srng.standard_normal(sf, dtype="float32") * 0.2).to(dev)
    check_norm_quant("3 kernel A", f"student [{rows}, {sf}]", dk.ln_leaky_rowquant,
                     dk.ln_leaky_rowquant_plain, (ys, ss, bs), 1e-6, dev)
    check_exact("3 kernel A", dk.ln_leaky_rowquant,
                (exact_sum_inputs(srng, (min(rows, TIME_ROWS), f), dev), scale, bias))
    return y, scale, bias, q_max


def check_kernel_b(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_0"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    kq, sk = dk._quant_phases(kernel)
    kp = dk.pack_k_major(kq)
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 18, 10, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    err = check_conv_equal("4 kernel B", f"[{rows}, 18, 10, {cin}]", dk.up2_conv4_int8,
                           dk.up2_conv4_int8_plain, (xq, sx, kp, sk, bias), dev, True)
    # a narrow width from a stream of its own, so that the serve's data do not change
    nx, nk, nsx, nb = narrow_conv_inputs(np.random.default_rng([seed, 4]), 4, 5, 3, 36, 70, dev)
    nkq, nsk = dk._quant_phases(nk)
    check_conv_equal("4 kernel B", "narrow [4, 5, 3, 36]", dk.up2_conv4_int8,
                     dk.up2_conv4_int8_plain, (nx, nsx, dk.pack_k_major(nkq), nsk, nb), dev, False)
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kp, sk, bias, err


def check_kernel_c(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    gn = gp["GroupNorm2d_0"]["GroupNorm_0"]
    scale = torch.as_tensor(gn["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(gn["bias"][0]).to(dev, torch.bfloat16).float()
    c = scale.shape[0]
    x = torch.as_tensor(rng.standard_normal((rows, 35, 19, c), dtype="float32") * 2.0
                        + 0.5).to(dev, torch.bfloat16)
    q_max = check_norm_quant("5 kernel C", f"[{rows}, 35, 19, {c}]", dk.gn_leaky_rowquant,
                             dk.gn_leaky_rowquant_plain, (x, scale, bias), 1e-5, dev)
    # the w=0.125 student's GroupNorm width, from a stream of its own
    srng = np.random.default_rng([seed, 5])
    sc_ = STUDENT_C
    xs = torch.as_tensor(srng.standard_normal((rows, 35, 19, sc_), dtype="float32") * 2.0
                         + 0.5).to(dev, torch.bfloat16)
    ss = torch.as_tensor(np.abs(srng.standard_normal(sc_, dtype="float32")) + 0.5).to(dev)
    bs = torch.as_tensor(srng.standard_normal(sc_, dtype="float32") * 0.3).to(dev)
    check_norm_quant("5 kernel C", f"student [{rows}, 35, 19, {sc_}]", dk.gn_leaky_rowquant,
                     dk.gn_leaky_rowquant_plain, (xs, ss, bs), 1e-5, dev)
    check_exact("5 kernel C", dk.gn_leaky_rowquant,
                (exact_sum_inputs(srng, (rows, 35, 19, c), dev), scale, bias))
    return x[:TIME_ROWS], scale, bias, q_max


def check_kernel_d(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.models.proton_fast import _row_phase_plan
    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_1"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    plans = _row_phase_plan(35, 56, 4, 1)[2]
    kq, sk, offsets = dk._quant_row_phases(kernel, plans)
    kp = dk.pack_k_major(kq)
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 35, 30, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    log("6 kernel D", f"row phases: real groups {dk.row_phase_groups(offsets)}, offsets {offsets}")
    err = check_conv_equal("6 kernel D", f"[{rows}, 35, 30, {cin}]", dk.row_resize_conv4_int8,
                           dk.row_resize_conv4_int8_plain, (xq, sx, kp, sk, offsets, bias, 56),
                           dev, True)
    # a narrow width from a stream of its own, so that the later checks' data do not change
    nx, nk, nsx, nb = narrow_conv_inputs(np.random.default_rng([seed, 6]), 4, 35, 30, 32, 32, dev)
    nkq, nsk, noff = dk._quant_row_phases(nk, plans)
    check_conv_equal("6 kernel D", "narrow [4, 35, 30, 32]", dk.row_resize_conv4_int8,
                     dk.row_resize_conv4_int8_plain,
                     (nx, nsx, dk.pack_k_major(nkq), nsk, noff, nb, 56), dev, False)
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kp, sk, offsets, bias, err


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


def check_kernels_gh(gp, rng, dev, rows):
    """Phase 7b: G and H against their plain versions on the Dense_1 output
    of ``rows`` showers of the teacher's expert 1 (bf16, as the engine holds
    it), with that expert's weights. Returns the inputs and the errors."""
    import torch

    from zdcsim_torch.convert import expert, from_jax_params, tree_to_torch
    from zdcsim_torch.models.proton_fast import mlp_apply
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    p = tree_to_torch(expert(from_jax_params(gp, {})[0], 1), dtype=torch.bfloat16, device=dev)
    noise, cond = (torch.as_tensor(rng.standard_normal((rows, n), dtype="float32"))
                   .to(dev, torch.bfloat16) for n in (10, 9))
    front, tail = fdk.front_weights(p), fdk.tail_weights(p)
    with torch.no_grad():
        x = mlp_apply(p, noise, cond)
        q, s = fdk.fused_decode_front(x, *front)
        qp, sp = fdk.fused_decode_front_plain(x, *front)
        out = fdk.fused_decode(x, *front, *tail)
        ref = fdk.fused_decode_plain(x, *front, *tail)
        counts = fdk.fused_decode(x, *front, *tail, apply_expm1=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    log("7b kernels G, H", f"G [{rows}, {x.shape[1]}] bf16 -> q {tuple(q.shape)}: max s rel err "
        f"{s_rel:.3e} (rtol 1e-5), max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%)")
    if not (q.shape == qp.shape and s.shape == sp.shape and s_rel <= 1e-5 and q_max <= 1
            and flips < 0.01):
        fail("kernel G disagrees with its plain version")
    err = (out - ref).abs().max().item()
    lim = 0.05 * ref.abs().max().item() + 0.05  # the int8 bound of the CPU tests
    e_rel, e_ok = within_rtol(counts, torch.expm1(out), 1e-5)
    log("7b kernels G, H", f"H [{rows}, {x.shape[1]}] bf16 -> {tuple(out.shape)} f32: max abs err "
        f"{err:.4e} (int8 bound {lim:.4f}); apply_expm1 against expm1 of the output: max rel "
        f"err {e_rel:.3e} (rtol 1e-5: {e_ok})")
    if not (out.shape == ref.shape and err < lim and e_ok and torch.isfinite(out).all()):
        fail("kernel H disagrees with its plain version")
    return p, x, front, tail, float(q_max), err


CONV_NAMES = {0: "Conv_0 (4 parity phases)", 1: "Conv_1", 2: "Conv_2"}
CONV0_SLABS = ((0, 9), (9, 6), (15, 6), (21, 4))  # (first tap, taps) of each parity phase


CONV_SOURCES = ("fused_decode", "up2_conv4_int8", "row_resize_conv4_int8")
DP4A_BODIES = ("up2_conv4_int8_kernel", "row_resize_conv4_int8_kernel")


def sass_label(name, index):
    """A readable label of a mangled kernel name from the SASS: the shared
    conv kernel as ``conv_mma_kernel<BN, f32|bf16> [source]`` (its anonymous
    namespace carries the source's name), a ``__dp4a`` body by its name with
    ``<f32|bf16>``; ``None`` for any other kernel."""
    import re

    out = "bf16" if "nv_bfloat16" in name else "f32"
    if "conv_mma_kernel" in name:
        bn = re.search(r"Li(\d+)E", name[name.index("conv_mma_kernel"):]).group(1)
        src = next((c for c in CONV_SOURCES if f"{c}_cu" in name), f"object {index}")
        return f"conv_mma_kernel<{bn}, {out}> [{src}]"
    return next((f"{b}<{out}>" for b in DP4A_BODIES if b in name), None)


def library_sass(lib_path):
    """``cuobjdump -sass`` of the built library; ``None`` where the toolkit
    has no ``cuobjdump``."""
    from zdcsim_torch.ops import _build

    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return None
    return subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=300,
                          check=True).stdout


def conv_sass_counts(sass):
    """Phase 2: ``{label: {op: count}}`` of the int8 tensor-core (``IMMA``,
    ``IGMMA``) and ``IDP4A`` instructions in each instantiation of the shared
    ``conv_mma_kernel`` and of B's and D's ``__dp4a`` bodies, from the
    library's SASS."""
    import re

    counts, fn, n_elf = {}, None, 0
    for line in sass.splitlines():
        if "Fatbin elf code" in line:
            n_elf += 1  # one ELF per compiled source
        if "Function :" in line:
            fn = sass_label(line.split("Function :")[1].strip(), n_elf)
            if fn is not None:
                while fn in counts:  # two sources' instantiations under one label
                    fn += "'"
                counts[fn] = dict.fromkeys(("IMMA", "IGMMA", "IDP4A"), 0)
            continue
        if fn:
            # opcodes as SASS spells them: IMMA.16832..., IGMMA.64x..., IDP.4A...
            for op in re.findall(r"\b(IMMA|IGMMA|IDP)(?=[.\s])", line):
                counts[fn]["IDP4A" if op == "IDP" else op] += 1
    return counts


def bulk_sass_counts(sass):
    """Phase 2: ``{label: Counter(opcode)}`` of every instruction in each
    instantiation of E's and F's bulk body (``expm1_sums_bulk_kernel<dtype,
    shape>``, ``any`` for the generic one), from the library's SASS."""
    import collections
    import re

    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            if "expm1_sums_bulk_kernel" in name:
                h, w = re.search(r"Li(\d+)ELi(\d+)E", name).groups()
                fn = (f"expm1_sums_bulk_kernel<{'bf16' if 'nv_bfloat16' in name else 'f32'}, "
                      f"{f'{h}x{w}' if h != '0' else 'any'}>")
                counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m:
            counts[fn][m.group(1)] += 1
    return counts


def check_conv_stages(x, front, tail, dev):
    """Phase 7b, the convs: each int8 conv that G and H launch
    (``fused_conv_int8``: Conv_0's parity phases, Conv_1, Conv_2) on the
    activations of that path (the plain versions' LN-quant of the Dense_1
    output, G's resized grid, GN1-quant of Conv_1's output), equal to its
    plain version bit for bit. Returns each conv's inputs."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    rows = x.shape[0]
    ln_s, ln_b, kp0, sk0, b0 = front[:5]
    kp1, sk1, b1, g1s, g1b, kp2, sk2, b2 = tail[:8]
    with torch.no_grad():
        xq, sx = dk.ln_leaky_rowquant_plain(x, ln_s, ln_b)
        q, s = fdk.fused_decode_front_plain(x, *front)
        y1 = fdk.fused_conv_int8_plain(1, q, s, kp1, sk1, b1)
        q2, s2 = dk.gn_leaky_rowquant_plain(y1, g1s, g1b, fdk.GROUPS)
        inputs = {0: (xq.reshape(rows, fdk.H0, fdk.W0, fdk.C0), sx.reshape(rows), kp0, sk0, b0),
                  1: (q, s, kp1, sk1, b1), 2: (q2, s2.reshape(rows), kp2, sk2, b2)}
        for conv, args in inputs.items():
            out = fdk.fused_conv_int8(conv, *args)
            ref = fdk.fused_conv_int8_plain(conv, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            same = out.shape == ref.shape and torch.equal(out, ref)
            e = (out - ref).abs().max().item() if out.shape == ref.shape else float("inf")
            log("7b conv stages", f"conv{conv} {CONV_NAMES[conv]} {list(args[0].shape)} int8 -> "
                f"{list(out.shape)} f32: equal to its plain version {same} (max abs err {e:.3e})")
            if not same:
                fail(f"the int8 conv {CONV_NAMES[conv]} of G/H differs from its plain version")
    return inputs


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


def serve_rate(eng, dev, n, batch, tile, card, seed, precision, phase="8 serve"):
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = eng.throughput_bulk(n_showers=n, generator=gen)
    peak = torch.cuda.max_memory_allocated(dev)
    log(phase, f"{precision} throughput_bulk: {stats['showers_per_sec']:.1f} showers/s "
        f"({n} showers in {stats['seconds']:.3f}s, batch {batch}, tile {tile}); "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def serve(gp, rp, rng, dev, n, batch, tile, card, seed, profile=False):
    """The yardstick ``int8`` serve, then each kernel path; returns the
    launch counts of each path's main run and the seeded router."""
    import numpy as np
    import torch

    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.router import RouterNetwork

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

    every = kernel_wrappers()
    wrappers = {name: every[name] for names in KERNEL_PATHS.values() for name in names}
    launches = {}
    for precision, names in KERNEL_PATHS.items():
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev)
        eng._build_switch(tile=tile)
        reset_counts(wrappers)
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_main = time.perf_counter() - t
        counts = read_counts(wrappers)
        launches[precision] = counts
        used = torch.bincount(ids, minlength=3).tolist()
        log("8 serve", f"{precision} main path: {n} showers, batch {batch}, tile {tile} in "
            f"{t_main:.3f}s; kernel launches {counts}; showers per expert {used}")
        if dev.type == "cuda" and min(counts[k] for k in names) <= 0:
            fail(f"the {precision} path did not launch each of its kernels {names}: {counts}")
        # the teacher's B (512 -> 256) and D (256 -> 128) run on the tensor cores
        off_mma = [k for k in names if counts.get(f"{k} on conv_mma", counts[k]) != counts[k]]
        if dev.type == "cuda" and off_mma:
            fail(f"the {precision} path ran {off_mma} off the tensor cores: {counts}")
        # A and C: every launch in clusters of its plan's k (the tiles' k
        # vary with their rows: 64 rows take k=2, a short last tile more)
        for k in names:
            if f"{k} on clusters" in counts:
                log("8 serve", f"{precision} {k}: {counts[k + ' on clusters']} of {counts[k]} "
                    f"launches in clusters of the plan's k")
        off_plan = [k for k in names if counts.get(f"{k} on clusters", counts[k]) != counts[k]]
        if dev.type == "cuda" and off_plan:
            fail(f"the {precision} path ran {off_plan} off their plan's cluster size: {counts}")
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
    return launches, router


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
    # the 15 costliest kernels, then those in anonymous namespaces, where every
    # kernel of the port lives (and a few of PyTorch's)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    for i, (name, (count, us)) in enumerate(ranked):
        if i < 15 or name.startswith("void (anonymous namespace)::"):
            print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}% {count:6d}x  {name[:110]}",
                  flush=True)


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


def graph_ms(fn, iters, replays=None):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed untimed for at least ``GRAPH_WARM`` replays and
    ``GRAPH_WARM_MS`` of card time, then 5 times, each replay between its
    own CUDA events; the mean call of the 5 is the time. A and C take 10-30
    us on the card, less than the host takes to launch one through its
    wrapper, so :func:`time_ms` measures the host there; replaying a graph
    does not. A card that comes from host-bound work runs the first tens of
    ms of load slower, so the untimed replays last that long.
    ``replays``, a list where given, receives every replay's ms a call, the
    untimed ones first."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start, first = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    first.record()
    first.synchronize()
    one_ms = start.elapsed_time(first)
    n_warm = max(GRAPH_WARM, -(-GRAPH_WARM_MS // one_ms))
    events = [first] + [torch.cuda.Event(enable_timing=True) for _ in range(int(n_warm) + 4)]
    for ev in events[1:]:
        graph.replay()
        ev.record()
    torch.cuda.synchronize()
    per_call = [one_ms / iters] + [a.elapsed_time(b) / iters for a, b in zip(events, events[1:])]
    if replays is not None:
        replays.extend(per_call)
    return events[-6].elapsed_time(events[-1]) / (5 * iters)


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


def pad1_taps(h, w, k):
    """Tap-positions of a ``k x k`` conv with one zero row/column before the
    ``[h, w]`` grid and its ``[h + 3 - k, w + 3 - k]`` output (H's Conv_1,
    Conv_2 and Conv_3) that read the grid; taps on the padding need no work."""
    def line(n):
        return sum(0 <= i + a - 1 < n for i in range(n + 3 - k) for a in range(k))
    return line(h) * line(w)


def bound(n_bytes, n_ops, ops_per_s, f32_ops=0):
    """``(bound in ms, what bounds it)``: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type
    (``f32_ops`` at the float32 rate, added to ``n_ops`` at ``ops_per_s``)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def int_mm_ms(kp, cin, gemms, gen):
    """``torch._int_mm`` on pre-built int8 matrices of a conv's GEMM shapes,
    a yardstick the port never calls: one ``[M, taps x Cin] x [taps x Cin,
    N]`` product per ``(M, first tap, taps)`` of ``gemms`` (no im2col), the
    B operand that slab of the packed weights ``kp`` (column-major, as
    cuBLASLt takes it). Returns ``(ms, TOP/s, [[M, K, N], ...])``."""
    import torch

    mats = []
    for m, tap0, taps in gemms:
        a = torch.randint(-127, 128, (m, taps * cin), generator=gen, device="cuda",
                          dtype=torch.int8)
        mats.append((a, kp[:, tap0 * cin:(tap0 + taps) * cin].contiguous().t()))
    ms = time_ms(lambda: [torch._int_mm(a, b) for a, b in mats], 50)
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in mats)
    return ms, ops / ms / 1e9, [[a.shape[0], a.shape[1], b.shape[1]] for a, b in mats]


def time_kernels(a_in, b_in, c_in, d_in, launches, errs, card):
    """Phase 9, kernels A-D at the serving tile; B and D also beside
    ``torch._int_mm`` on their GEMM shapes."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(90)

    y, scale, bias = a_in
    y = y[:TIME_ROWS].contiguous()
    rows, f = y.shape
    a_ms = graph_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_eager = time_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_plain = time_ms(lambda: dk.ln_leaky_rowquant_plain(y, scale, bias), 10)
    a_bytes = rows * f * 2 + 2 * f * 4 + rows * f + rows * 4
    a_ops = rows * f * 13  # mean 1, variance 3, normalise+affine 4, leaky 1, amax 1, quantise 3

    xq, sx, kp, sk, cbias = b_in
    nb, h, w, cin = xq.shape
    cout = kp.shape[0]
    b_ms = time_ms(lambda: dk.up2_conv4_int8(xq, sx, kp, sk, cbias, torch.bfloat16), 50)
    b_plain = time_ms(lambda: dk.up2_conv4_int8_plain(xq, sx, kp, sk, cbias, torch.bfloat16), 3)
    b_ops = 2 * nb * in_grid_taps(h, w) * cin * cout
    b_bytes = (xq.numel() + nb * 4 + kp.numel() + sk.numel() * 4 + cout * 4
               + nb * (2 * h - 1) * (2 * w - 1) * cout * 2)
    b_mm = int_mm_ms(kp, cin, [(nb * h * w, t0, t) for t0, t in CONV0_SLABS], gen)

    x, gscale, gbias = c_in
    x = x.contiguous()
    c_ms = graph_ms(lambda: dk.gn_leaky_rowquant(x, gscale, gbias), 50)
    c_eager = time_ms(lambda: dk.gn_leaky_rowquant(x, gscale, gbias), 50)
    c_plain = time_ms(lambda: dk.gn_leaky_rowquant_plain(x, gscale, gbias), 10)
    c_bytes = x.numel() * 2 + 2 * x.shape[-1] * 4 + x.numel() + x.shape[0] * 4
    c_ops = x.numel() * 13  # sums 3, normalise+affine 4, leaky 1, amax 1, quantise 3, +1 rounding

    dq, dsx, dkp, dsk, offsets, dbias = d_in
    dq = dq.contiguous()
    nd, hd, wd, dcin = dq.shape
    dcout = dkp.shape[0]
    d_ms = time_ms(lambda: dk.row_resize_conv4_int8(dq, dsx, dkp, dsk, offsets, dbias, 56,
                                                    torch.bfloat16), 50)
    d_plain = time_ms(lambda: dk.row_resize_conv4_int8_plain(dq, dsx, dkp, dsk, offsets, dbias,
                                                             56, torch.bfloat16), 3)
    d_ops = 2 * nd * row_resize_taps(hd, wd, 56) * dcin * dcout
    d_bytes = (dq.numel() + nd * 4 + dkp.numel() + dsk.numel() * 4 + dcout * 4
               + nd * 55 * wd * dcout * 2)
    max_l = len(offsets[0])
    d_mm = int_mm_ms(dkp, dcin, [(nd * ((55 - p + 7) // 8) * wd, p * max_l * 4, 4 * n)
                                 for p, n in enumerate(dk.row_phase_groups(offsets))], gen)

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
    for r, ((mm, mm_tops, shapes), n_ops) in ((rec[1], (b_mm, b_ops)), (rec[3], (d_mm, d_ops))):
        r["int_mm_ms"] = mm
        log("9 kernel times", f"{r['name']} on the int8 tensor cores: {r['ms']:.4f} ms "
            f"({n_ops / r['ms'] / 1e9:.1f} TOP/s on the in-grid taps); "
            f"torch._int_mm on pre-built [M, K, N] {shapes}: {mm:.4f} ms "
            f"({mm_tops:.1f} TOP/s); {launches[r['name'] + ' on conv_mma']} of its "
            f"{r['launches']} launches on the tensor cores [{card}]")
    for r, eager in ((rec[0], a_eager), (rec[2], c_eager)):
        r["eager_ms"] = eager
        log("9 kernel times", f"{r['name']}: {r['ms']:.4f} ms a launch replayed in a CUDA "
            f"graph, {eager:.4f} ms a launch through the wrapper's host loop [{card}]")
    for r in rec:
        log("9 kernel times", f"{r['name']} at {TIME_ROWS} rows: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, {r['launches']} launches per "
            f"{N_SHOWERS} showers on the int8_pallas path [{card}]")
    return rec


def sweep_clusters(rec, a_in, c_in, card):
    """Phase 9, A and C: every cluster size of ``CLUSTER_SIZES`` at
    ``SWEEP_ROWS`` rows of the serving shapes (:func:`graph_ms`), beside how many
    such clusters the card holds at once; the plan's k is marked. Adds the
    sweep to A's and C's records as ``k_sweep``."""
    from zdcsim_torch.ops import decode_kernels as dk

    for r, fn, (data, *params) in ((rec[0], dk.ln_leaky_rowquant, a_in),
                                   (rec[2], dk.gn_leaky_rowquant, c_in)):
        kind, sample = norm_sample(data)
        sweep = []
        for rows in SWEEP_ROWS:
            xs = data[:rows].contiguous()
            plan_k = dk.norm_quant_plan(kind, rows, sample, xs.element_size()).k
            for k in dk.CLUSTER_SIZES:
                p = dk.norm_quant_plan(kind, rows, sample, xs.element_size(), k)
                ms = graph_ms(lambda: fn(xs, *params, k=k), 50)
                n = dk.norm_quant_max_clusters(kind, xs.dtype, sample, k)
                sweep.append({"rows": rows, "k": k, "ms": ms, "max_active_clusters": n,
                              "kept": p.kept, "plan": k == plan_k})
                log("9 cluster sweep", f"{r['name']} [{rows}, {', '.join(map(str, sample))}] "
                    f"{str(xs.dtype)[6:]} k={k}: {ms:.4f} ms; {n} such clusters fit at once; "
                    f"{p.threads} threads, {p.smem} B shared, share "
                    f"{'kept' if p.kept else 'streamed'}{'  <- plan' if k == plan_k else ''} "
                    f"[{card}]")
        r["k_sweep"] = sweep


def time_conv_stages(conv_in, card):
    """Phase 9, the convs: each int8 conv of G and H with CUDA events at the
    serving tile, beside its int8 bound (the taps that read the source grid)
    and ``torch._int_mm`` on pre-built ``[M, K] x [K, N]`` int8 matrices of
    the same GEMM shapes (one per Conv_0 phase, the full K; no im2col), a
    yardstick the port never calls. Returns ``{"conv<i>": ms}``."""
    import torch

    from zdcsim_torch.ops import fused_decode_kernels as fdk

    gen = torch.Generator(device="cuda").manual_seed(9)
    taps = {0: in_grid_taps(18, 10), 1: pad1_taps(56, 30, 4), 2: pad1_taps(55, 29, 3)}
    slabs = {0: CONV0_SLABS, 1: ((0, 16),), 2: ((0, 9),)}
    times = {}
    for conv, args in conv_in.items():
        xq, sx, kp, sk, bias = args
        rows = xq.shape[0]
        (h, w, cin), (oh, ow, cout) = fdk.CONVS[conv][:2]
        with torch.no_grad():
            ms = time_ms(lambda: fdk.fused_conv_int8(conv, *args), 50)
        n_ops = 2 * rows * taps[conv] * cin * cout
        n_bytes = (xq.numel() + kp.numel() + 4 * (sx.numel() + sk.numel() + bias.numel())
                   + 4 * rows * oh * ow * cout)
        bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
        m = rows * (h * w if conv == 0 else oh * ow)
        mm_ms, mm_tops, shapes = int_mm_ms(kp, cin, [(m, t0, t) for t0, t in slabs[conv]], gen)
        times[f"conv{conv}"] = ms
        log("9 conv times", f"conv{conv} {CONV_NAMES[conv]} at {rows} rows: {ms:.4f} ms "
            f"({n_ops / ms / 1e9:.1f} TOP/s on the in-grid taps), bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound; torch._int_mm on pre-built "
            f"[M, K, N] {shapes}: {mm_ms:.4f} ms ({mm_tops:.1f} TOP/s) [{card}]")
    return times


def time_fused(p, x, front, tail, launches, errs, conv_ms, card):
    """Phase 9, G and H: CUDA-event times at the serving tile beside their
    plain versions and the ported chains that compute the same functions
    (kernels A -> B (f32 out) -> C -> the resize gather; the ``int8_pallas``
    decode after the MLP); ``conv_ms`` (phase 9's conv times) goes into
    their records."""
    import torch

    from zdcsim_torch.models.proton_fast import decode_apply, quantize_weights
    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    x = x[:TIME_ROWS].contiguous()
    rows, f = x.shape
    ln_s, ln_b, kp0, sk0, b0, g0s, g0b = front
    qw = quantize_weights(p, "pallas")

    def chain_g():
        xq, sx = dk.ln_leaky_rowquant(x, ln_s, ln_b)
        y0 = dk.up2_conv4_int8(xq.reshape(rows, 18, 10, -1), sx, kp0, sk0, b0, torch.float32)
        q, s = dk.gn_leaky_rowquant(y0, g0s, g0b)
        return fdk._gather_resize(q), s

    def chain_h():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return decode_apply(p, x, torch.bfloat16, int8=True, int8_backend="pallas", qweights=qw)

    with torch.no_grad():
        g_ms = time_ms(lambda: fdk.fused_decode_front(x, *front), 20)
        g_plain = time_ms(lambda: fdk.fused_decode_front_plain(x, *front), 3)
        g_chain = time_ms(chain_g, 20)
        h_ms = time_ms(lambda: fdk.fused_decode(x, *front, *tail), 20)
        h_plain = time_ms(lambda: fdk.fused_decode_plain(x, *front, *tail), 3)
        h_chain = time_ms(chain_h, 20)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # int8 operations on the taps that read each source grid; f32 operations:
    # LN as kernel A (13 an element), each GroupNorm as kernel C (13) and each
    # conv epilogue (3) per element, GN2 without the quant (9), Conv_3 (2 a tap)
    g_i8 = 2 * rows * in_grid_taps(18, 10) * 512 * 256
    g_f32 = rows * (f * 13 + 35 * 19 * 256 * 16)
    h_i8 = g_i8 + 2 * rows * (pad1_taps(56, 30, 4) * 256 * 128 + pad1_taps(55, 29, 3) * 128 * 64)
    h_f32 = g_f32 + rows * (55 * 29 * (128 * 16 + 64 * 12) + 2 * pad1_taps(55, 29, 2) * 64
                            + 56 * 30 * 2)
    g_bytes = nbytes((x,) + front) + rows * 56 * 30 * 256 + rows * 4
    h_bytes = nbytes((x,) + front + tail) + rows * 56 * 30 * 4
    rec = []
    for name, replaces, ms, plain, chain, n_bytes, i8, f32, n, err, what, convs in (
        ("fused_decode_front", "zdcsim/ops/pallas_decode_fused.py:586", g_ms, g_plain, g_chain,
         g_bytes, g_i8, g_f32, launches["int8_fused_front"]["fused_decode_front"], errs[0],
         "A -> B(f32) -> C -> gather", ("conv0",)),
        ("fused_decode", "zdcsim/ops/pallas_decode_fused.py:479", h_ms, h_plain, h_chain,
         h_bytes, h_i8, h_f32, launches["int8_fused"]["fused_decode"], errs[1],
         "the int8_pallas decode", ("conv0", "conv1", "conv2")),
    ):
        bound_ms, bound_by = bound(n_bytes, i8, INT8_OPS_PER_S, f32)
        rec.append({"name": name, "route": "cuda", "source": "zdcsim_torch/csrc/fused_decode.cu",
                    "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, "chain_ms": chain,
                    "conv_ms": {c: conv_ms[c] for c in convs}})
        log("9 kernel times", f"{name} at {rows} rows: {ms:.4f} ms (its convs "
            f"{sum(conv_ms[c] for c in convs):.4f} ms), plain {plain:.4f} ms, "
            f"chain ({what}) {chain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.1f}% of bound, {n} launches per {N_SHOWERS} showers on "
            f"its path [{card}]")
    return rec


def within_rtol(out, ref, rtol):
    """``(max relative error, all within rtol)`` of two tensors."""
    err = (out - ref).abs()
    return (err / ref.abs().clamp(min=1e-30)).max().item(), bool((err <= rtol * ref.abs()).all())


def gate_data(dev, rehearse):
    """Phase 10: the gate's test split (numpy), and kernel E against its plain
    version on its real showers (f32 and bf16) and on a neutron-sized batch,
    each launch on the bulk ring."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.ops import epilogue_kernels as ek

    t = time.perf_counter()
    overrides = [*ft.GATE_OVERRIDES]
    if rehearse:
        overrides.append(f"dataset.synthetic_n_samples={REHEARSE_SPLIT}")
    cond, real = ft.gate_split(load_config(overrides))
    log("10 kernel E", f"gate split in {time.perf_counter() - t:.2f}s: test cond {cond.shape}, "
        f"real {real.shape}, first test showers' photon sums "
        f"{np.expm1(real[:3]).sum(axis=(1, 2)).round(1).tolist()}")
    rng = np.random.default_rng(10)
    shown = real[:8] if rehearse else real
    errs = []
    for x, dt in ((shown, torch.float32), (shown, torch.bfloat16),
                  (rng.random((37, 44, 44), dtype=np.float32) * 3, torch.float32)):
        xt = torch.as_tensor(x).to(dev, dt)
        k0 = ek.expm1_channel_sums.bulk_launches
        out, ref = ek.expm1_channel_sums(xt), ek.expm1_channel_sums_plain(xt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rel, ok = within_rtol(out, ref, 1e-5)
        errs.append((out - ref).abs().max().item())
        on_bulk = ek.expm1_channel_sums.bulk_launches == k0 + 1
        ran = (f"on the bulk ring {on_bulk}" if dev.type == "cuda"
               else "plain version on the CPU; the card runs the bulk ring")
        log("10 kernel E", f"{list(x.shape)} {str(dt)[6:]} -> {list(out.shape)}: max rel err "
            f"{rel:.3e} (rtol 1e-5: {ok}), max abs err {errs[-1]:.3e} ({ran})")
        if not ok or not torch.isfinite(out).all():
            fail("kernel E disagrees with its plain version")
        if dev.type == "cuda" and not on_bulk:
            fail(f"kernel E on {list(x.shape)} {dt} did not run on the bulk ring")
    return cond, real, max(errs)


def kernel_f_path(gp, router, dev, n, card):
    """Phase 11: the teacher's all-expert log-space decode of ``n`` showers
    (each expert decodes every shower), routed by phase 8's seeded router,
    into kernel F; F against its plain version, and bit-equal to kernel E
    on the routed rows, both on the bulk ring. Returns ``(launches of F,
    its bulk-ring launches, max abs err)``."""
    import numpy as np
    import torch

    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.proton_fast import fast_generator_apply
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(11)
    cond = torch.as_tensor(rng.standard_normal((n, 9), dtype="float32")).to(dev)
    noise = torch.as_tensor(rng.standard_normal((n, 10), dtype="float32")).to(dev)
    eng = FastSim(gp, router, batch_size=n, precision="int8", device=dev)
    with torch.no_grad():
        ids = eng.router(cond)[1].argmax(-1)
        for fn in (ek.expm1_channel_sums, ek.routed_expm1_channel_sums):
            fn.launches = fn.bulk_launches = 0
        imgs = torch.stack([
            fast_generator_apply(p, noise.to(torch.bfloat16), cond.to(torch.bfloat16), int8=True,
                                 qweights=q)[..., 0].to(torch.float32)
            for p, q in zip(eng._experts, eng._qweights)])
        out = ek.routed_expm1_channel_sums(imgs, ids)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    launches = ek.routed_expm1_channel_sums.launches
    bulk = ek.routed_expm1_channel_sums.bulk_launches
    used = torch.bincount(ids, minlength=3).tolist()
    log("11 kernel F", f"all-expert decode {list(imgs.shape)} f32 (log space) -> F: {launches} "
        f"launch(es), {bulk} on the bulk ring; showers per expert {used} [{card}]")
    if dev.type == "cuda" and (launches <= 0 or bulk != launches):
        fail("the all-expert path did not launch kernel F on the bulk ring")
    if min(used) <= 0:
        fail(f"the seeded router left an expert unread: {used}")
    ref = ek.routed_expm1_channel_sums_plain(imgs, ids)
    e_bulk = ek.expm1_channel_sums.bulk_launches
    rows = ek.expm1_channel_sums(imgs[ids, torch.arange(n, device=dev)].contiguous())
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if ek.expm1_channel_sums.bulk_launches != e_bulk + 1:
            fail("kernel E on the routed rows did not run on the bulk ring")
    rel, ok = within_rtol(out, ref, 1e-5)
    same = torch.equal(out, rows)
    err = (out - ref).abs().max().item()
    log("11 kernel F", f"F vs plain: max rel err {rel:.3e} (rtol 1e-5: {ok}), max abs err "
        f"{err:.3e}; F bit-equal to E on the routed rows: {same}")
    if not (ok and same and torch.isfinite(out).all()):
        fail("kernel F disagrees with its plain version or with kernel E")
    return launches, bulk, err


def float_serves(gp, router, dev, n, batch, tile, card, seed):
    """Phase 12: ``f32`` and ``bf16`` serves of ``n`` teacher showers against
    ``int8`` on the same conditions and noise, with phase 8's router."""
    import numpy as np
    import torch

    from zdcsim_torch.inference.engine import FastSim

    rng = np.random.default_rng(12)
    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    ref_ids, b = None, None
    for precision in ("int8", "f32", "bf16"):
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev)
        eng._build_switch(tile=tile)
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
        imgs, ids = imgs.cpu().numpy(), ids.cpu().numpy()
        dt = time.perf_counter() - t
        if imgs.shape != (n, 56, 30) or not np.isfinite(imgs).all() or imgs.min() < 0:
            fail(f"{precision}: served showers not finite/non-negative of shape ({n}, 56, 30)")
        a = np.log1p(imgs.sum(axis=(1, 2)))
        if ref_ids is None:
            ref_ids, b = ids, a
            log("12 float serves", f"int8 reference: {n} showers in {dt:.3f}s, showers per "
                f"expert {np.bincount(ids, minlength=3).tolist()}")
        else:
            rel = np.abs(a - b) / np.abs(b)
            same_ids = bool((ids == ref_ids).all())
            log("12 float serves", f"{precision}: {n} showers in {dt:.3f}s; routing identical "
                f"to int8 {same_ids}; max rel diff of per-shower log1p sums {rel.max():.4f} "
                f"(rtol 0.15)")
            if not same_ids or rel.max() > 0.15:
                fail(f"{precision} and int8 serving disagree")
        if dev.type == "cuda" and precision != "int8":
            serve_rate(eng, dev, n, batch, tile, card, seed, precision, "12 float serves")
        del eng


def gates(data, dev, rehearse, card):
    """Phase 13: the fidelity gate (``fidelity_torch.run_gate``) on the
    teacher at ``int8``, ``int8_pallas`` and ``int8_fused`` and on the w=0.125 student at
    ``int8``; every kernel count is set to 0 just before each gate and read
    just after; every launch of E must be on the bulk ring. Returns kernel
    E's launches and bulk-ring launches of the first gate (the teacher's
    ``int8``)."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.ops import epilogue_kernels as ek

    cond, real = data
    ch_real = ek.expm1_channel_sums(torch.as_tensor(real).to(dev))
    floor = ft.real_floor(ch_real)[0]
    log("13 gate", f"real-vs-real floor {floor:.4f} on {len(cond)} test showers (CPU test "
        f"anchor on the full split: {FLOOR_ANCHOR}; not a check here) [{card}]")
    wrappers = kernel_wrappers()
    runs = ([(STUDENT, "int8")] if rehearse
            else [(TEACHER, "int8"), (TEACHER, "int8_pallas"), (TEACHER, "int8_fused"),
                  (STUDENT, "int8")])
    e_launches = None
    for path, precision in runs:
        reset_counts(wrappers)
        t = time.perf_counter()
        rec = ft.run_gate(path, precision, dev, data=data, n_draws=1 if rehearse else ft.N_DRAWS)
        counts = read_counts(wrappers)
        print(json.dumps(rec), flush=True)
        log("13 gate", f"{os.path.basename(path)} {precision}: {time.perf_counter() - t:.2f}s, "
            f"value {rec['value']} x floor, vs_baseline {rec['vs_baseline']}; kernel launches "
            f"{counts} [{card}]")
        needs = ("expm1_channel_sums",) + (KERNEL_PATHS[precision] if precision in KERNEL_PATHS
                                           else ())
        if dev.type == "cuda" and min(counts[k] for k in needs) <= 0:
            fail(f"the {precision} gate did not launch each of its kernels {needs}: {counts}")
        e_bulk = counts["expm1_channel_sums on the bulk ring"]
        if dev.type == "cuda" and e_bulk != counts["expm1_channel_sums"]:
            fail(f"the {precision} gate ran kernel E off the bulk ring: {counts}")
        if not (np.isfinite(rec["value"]) and rec["vs_baseline"] >= 1.0):
            fail(f"the gate of {os.path.basename(path)} at {precision} did not pass: {rec}")
        if e_launches is None:
            e_launches = (counts["expm1_channel_sums"], e_bulk)
    return e_launches


def time_epilogues(e_counts, f_counts, errs, card):
    """Phase 14: kernels E and F at ``EF_TIME_ROWS`` showers of 56x30 in f32
    and bf16 (E also at the gate's 5120 in f32), replayed in a CUDA graph
    (a launch through the wrapper takes the host about as long as the bulk
    body takes the card), beside the host loop's time, the direct body
    forced on the same input (graph-replayed), their plain versions, the
    library's ``expm1``
    then the channel-basis matmul (F: the routed gather first) and the
    bound. ``e_counts``/``f_counts``: ``(launches, bulk-ring launches)`` of
    their main paths."""
    import torch

    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.ops.channels import channel_basis

    h, w = 56, 30
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.rand((EF_TIME_ROWS, h, w), generator=gen, device="cuda") * 5
    imgs = torch.rand((3, EF_TIME_ROWS, h, w), generator=gen, device="cuda") * 5
    ids = torch.randint(0, 3, (EF_TIME_ROWS,), generator=gen, device="cuda")
    basis = torch.as_tensor(channel_basis((h, w)), device="cuda")

    def e_case(xd):
        b = xd.shape[0]
        return (lambda **kw: ek.expm1_channel_sums(xd, **kw),
                lambda: ek.expm1_channel_sums_plain(xd),
                lambda: torch.expm1(xd.float()).reshape(b, h * w) @ basis,
                b * h * w * xd.element_size() + b * 5 * 4, b)

    def f_case(imd):
        b = imd.shape[1]
        rows = torch.arange(b, device="cuda")
        return (lambda **kw: ek.routed_expm1_channel_sums(imd, ids, **kw),
                lambda: ek.routed_expm1_channel_sums_plain(imd, ids),
                lambda: torch.expm1(imd[ids, rows].float()).reshape(b, h * w) @ basis,
                # each routed row read once, ids once, sums written once
                b * h * w * imd.element_size() + b * 8 + b * 5 * 4, b)

    cases = {"expm1_channel_sums": [], "routed_expm1_channel_sums": []}
    for dt in (torch.float32, torch.bfloat16):
        cases["expm1_channel_sums"].append((dt, e_case(x.to(dt))))
        cases["routed_expm1_channel_sums"].append((dt, f_case(imgs.to(dt))))
    cases["expm1_channel_sums"].append((torch.float32, e_case(x[:5120].contiguous())))
    clocks = "clocks.sm,clocks.mem,power.draw"
    log("14 epilogue times", f"{clocks} before the first case: {card_line(clocks)} [{card}]")
    rec = []
    for name, replaces, (launches, bulk), err in (
        ("expm1_channel_sums", "zdcsim/ops/pallas_kernels.py:103", e_counts, errs[0]),
        ("routed_expm1_channel_sums", "zdcsim/ops/pallas_kernels.py:62", f_counts, errs[1]),
    ):
        timed_cases = []
        for dt, (fn, plain, lib, n_bytes, b) in cases[name]:
            # expm1 and one add per pixel (the other channels' sums are not the work)
            bound_ms, bound_by = bound(n_bytes, 2 * b * h * w, F32_OPS_PER_S)
            reps = []
            c = {"showers": b, "dtype": str(dt)[6:], "graph_ms": graph_ms(fn, 50, reps),
                 "replays_ms": reps, "eager_ms": time_ms(fn, 50),
                 "old_body_ms": graph_ms(lambda: fn(_direct_body=True), 50),
                 "plain_ms": time_ms(plain, 20), "library_ms": time_ms(lib, 20),
                 "bound_ms": bound_ms, "bound_by": bound_by}
            timed_cases.append(c)
            log("14 epilogue times", f"{name} [{b}, {h}, {w}] {c['dtype']}: {c['graph_ms']:.4f} ms "
                f"replayed in a CUDA graph, {100 * bound_ms / c['graph_ms']:.1f}% of its bound "
                f"{bound_ms:.4f} ms ({bound_by}); host loop {c['eager_ms']:.4f} ms; direct body "
                f"{c['old_body_ms']:.4f} ms; plain {c['plain_ms']:.4f} ms; library "
                f"{c['library_ms']:.4f} ms; a call in each replay {fmt_replays(reps)} [{card}]")
        main = timed_cases[0]
        rec.append({"name": name, "route": "cuda",
                    "source": "zdcsim_torch/csrc/expm1_channel_sums.cu", "replaces": replaces,
                    "launches": launches, "max_abs_err": err, "ms": main["graph_ms"],
                    "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                    "body": "bulk ring" if bulk == launches else "direct",
                    "bulk_launches": bulk, "graph_ms": main["graph_ms"],
                    "eager_ms": main["eager_ms"], "old_body_ms": main["old_body_ms"],
                    "cases": timed_cases})
    # the first case again, last: a reading that depends on its place in the
    # phase shows here
    fn, b = cases["expm1_channel_sums"][0][1][0], EF_TIME_ROWS
    reps = []
    again = rec[0]["cases"][0]["graph_ms_again"] = graph_ms(fn, 50, reps)
    log("14 epilogue times", f"expm1_channel_sums [{b}, {h}, {w}] float32 again after the other "
        f"cases: {again:.4f} ms replayed in a CUDA graph; a call in each replay "
        f"{fmt_replays(reps)} [{card}]")
    log("14 epilogue times", f"{clocks} after: {card_line(clocks)} [{card}]")
    return rec


def fmt_replays(reps):
    """``graph_ms``'s replays as ms a call: the untimed ones (their count,
    the first 3 and the last) | the 5 timed ones."""
    warm, timed = reps[:-5], reps[-5:]
    return (f"{len(warm)} untimed " + " ".join(f"{r:.4f}" for r in warm[:3])
            + f" .. {warm[-1]:.4f} | " + " ".join(f"{r:.4f}" for r in timed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-13 on the CPU at small sizes with the plain versions")
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
        sass = library_sass(lib_path)
        if sass is None:
            log("2 build", "no cuobjdump beside nvcc: SASS instruction counts not measured")
        else:
            for fn, c in bulk_sass_counts(sass).items():
                ops = ", ".join(f"{op} {c[op]}" for op in ("MUFU", "LDS", "FFMA", "FADD", "FMUL",
                                                          "FSETP", "FSEL", "FRND"))
                log("2 build", f"SASS of {fn}: {sum(c.values())} instructions ({ops}); a lane "
                    f"sums 52.5 pixels of a 56x30 shower, 60.5 of 44x44")
            counts = conv_sass_counts(sass)
            n_mma = 0
            for fn, c in counts.items():
                log("2 build", f"SASS of {fn}: IMMA {c['IMMA']}, IGMMA {c['IGMMA']}, IDP4A "
                    f"{c['IDP4A']}")
                if fn.startswith("conv_mma_kernel"):
                    n_mma += 1
                    if c["IGMMA"] == 0 or c["IMMA"] or c["IDP4A"]:
                        fail(f"{fn} does not run on wgmma alone: {c}")
            # G's and H's source launches 2 instantiations, B's and D's 4 each
            if n_mma < 10:
                fail(f"the library's SASS holds {n_mma} conv_mma_kernel instantiations, not 10")

    rng = np.random.default_rng(args.seed)
    gp, _, rp, _ = load_serving_artifact(TEACHER)
    log("3 kernel A", "teacher artifact loaded")
    PHASE_S["setup"] = time.perf_counter() - T0  # imports, card, build, artifact
    a_in = timed("3 A", check_kernel_a, gp, rng, dev, 8 if rehearse else A_ROWS, args.seed)
    b_in = timed("4 B", check_kernel_b, gp, rng, dev, 8 if rehearse else B_ROWS, args.seed)
    # the later checks draw from a stream of their own, so the serve's
    # conditions and router stay those that phases 3-4 leave
    rng_cd = np.random.default_rng([args.seed, 1])
    c_in = timed("5 C", check_kernel_c, gp, rng_cd, dev, 4 if rehearse else C_ROWS, args.seed)
    d_in = timed("6 D", check_kernel_d, gp, rng_cd, dev, 2 if rehearse else D_ROWS, args.seed)
    timed("7 conv_i8", check_conv_i8, gp, rng_cd, dev, 1 if rehearse else 2)
    gh_in = timed("7b G, H", check_kernels_gh, gp, rng_cd, dev, 1 if rehearse else GH_ROWS)
    conv_in = timed("7b G, H", check_conv_stages, *gh_in[1:4], dev)
    if rehearse:
        _, router = timed("8 serve", serve, gp, rp, rng, dev, *REHEARSE_SERVE, card, args.seed)
        cond, real, _ = timed("10 E", gate_data, dev, rehearse)
        timed("11 F", kernel_f_path, gp, router, dev, REHEARSE_F, card)
        timed("12 float serves", float_serves, gp, router, dev, *REHEARSE_FLOAT, card, args.seed)
        timed("13 gate", gates, (cond[:REHEARSE_GATE], real[:REHEARSE_GATE]), dev, rehearse,
              card)
        log_phase_times()
        print(json.dumps({"rehearsal": True}), flush=True)
        return 0
    launches, router = timed("8 serve", serve, gp, rp, rng, dev, N_SHOWERS, SERVE_BATCH,
                             SERVE_TILE, card, args.seed, args.profile)
    rec = timed("9 kernel times", time_kernels, a_in[:3], b_in[:5], c_in[:3], d_in[:6],
                launches["int8_pallas"], (a_in[3], b_in[5], c_in[3], d_in[6]), card)
    timed("9 kernel times", sweep_clusters, rec, a_in[:3], c_in[:3], card)
    conv_ms = timed("9 kernel times", time_conv_stages, conv_in, card)
    rec += timed("9 kernel times", time_fused, *gh_in[:4], launches, gh_in[4:], conv_ms, card)
    cond, real, e_err = timed("10 E", gate_data, dev, rehearse)
    f_launches, f_bulk, f_err = timed("11 F", kernel_f_path, gp, router, dev, F_SHOWERS, card)
    timed("12 float serves", float_serves, gp, router, dev, FLOAT_SHOWERS, SERVE_BATCH,
          SERVE_TILE, card, args.seed)
    e_counts = timed("13 gate", gates, (cond, real), dev, rehearse, card)
    rec += timed("14 epilogue times", time_epilogues, e_counts, (f_launches, f_bulk),
                 (e_err, f_err), card)
    log_phase_times()
    log("done", f"wall {time.perf_counter() - T0:.2f}s [{card}]")
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
