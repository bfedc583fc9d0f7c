"""Operations and bytes of the serving decode, from its shapes alone.

Frozen here, so that a change to the program cannot change the yardstick.
Where a conv reads a nearest upsample or resize, the count takes the taps
that the work needs:

- a 4x4 pad-1 conv of a 2x upsample (the proton Conv_0) as four parity-phase
  convs on the source grid, each output reading the source positions of its
  phase's merged taps, none on the zero halo (:func:`in_grid_taps`; kernels B,
  G and H);
- a nearest row resize folded into a 4-tap row conv (kernel D) as its row
  phases' merged row groups (:func:`row_resize_taps`);
- a 4x4, 3x3 or 2x2 pad-1 conv on a grid it does not resize (H's Conv_1 on
  its resized 56x30 grid, Conv_2, Conv_3) as the taps that fall on the grid
  (:func:`pad1_taps`);
- a 3x3 VALID conv of a 2x upsample (the neutron Conv_0 and Conv_1) as the
  2x2 distinct source positions every output's window reads.

An operation is a multiply or an add: a multiply-add counts 2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from counts.peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, PEAK

# the four parity phases of a 4x4 conv of a 2x upsample, with their source
# offsets (row, column) after the taps that read one source position merge
PHASE_OFFSETS = {
    "ee": [(a - 1, b - 1) for a in range(3) for b in range(3)],
    "eo": [(a - 1, b) for a in range(3) for b in range(2)],
    "oe": [(a, b - 1) for a in range(2) for b in range(3)],
    "oo": [(a, b) for a in range(2) for b in range(2)],
}


def in_grid_taps(h: int, w: int) -> int:
    """Tap-positions of the ``[2h-1, 2w-1]`` output that read the ``[h, w]``
    source grid: phase ``ee`` covers h x w positions, an odd row or column
    phase one fewer; taps on the zero halo need no work."""
    n = 0
    for name, offsets in PHASE_OFFSETS.items():
        rows = h if name[0] == "e" else h - 1
        cols = w if name[1] == "e" else w - 1
        for dr, dc in offsets:
            n += (sum(0 <= i + dr < h for i in range(rows))
                  * sum(0 <= j + dc < w for j in range(cols)))
    return n


def pad1_taps(h: int, w: int, k: int) -> int:
    """Tap-positions of a ``k x k`` conv with one zero row/column before the
    ``[h, w]`` grid and its ``[h + 3 - k, w + 3 - k]`` output that read the
    grid."""
    def line(n):
        return sum(0 <= i + a - 1 < n for i in range(n + 3 - k) for a in range(k))
    return line(h) * line(w)


def nearest_index(n_out: int, n_in: int) -> List[int]:
    return [math.floor((i + 0.5) * n_in / n_out) for i in range(n_out)]


def row_phase_plan(n_in: int, n_out: int, ksize: int, pad: int):
    """The row phases of a nearest row resize ``n_in -> n_out`` folded into
    a ``ksize``-tap row conv: ``(q, p, plans)``, one ``(d0, groups,
    n_phase)`` a phase, ``groups`` the ``(source row offset, merged taps)``."""
    g = math.gcd(n_in, n_out)
    p_num, q = n_in // g, n_out // g
    src = nearest_index(n_out, n_in)
    n_conv_out = n_out + 2 * pad - ksize + 1
    plans = []
    for phase in range(q):
        rel = [src[phase - pad + a] if 0 <= phase - pad + a < n_out else src[0] - 1
               for a in range(ksize)]
        groups, cur, cur_rows = [], [0], rel[0]
        for a in range(1, ksize):
            if rel[a] == cur_rows:
                cur.append(a)
            else:
                groups.append((cur_rows, cur))
                cur, cur_rows = [a], rel[a]
        groups.append((cur_rows, cur))
        plans.append((rel[0], groups, (n_conv_out - phase + q - 1) // q))
    return q, p_num, plans


def row_resize_taps(h: int, w: int, n_resized_rows: int) -> int:
    """(Row group, column) tap-positions of kernel D's ``[n_resized_rows - 1,
    w]`` output that read the ``[h, w]`` source grid."""
    _, p_num, plans = row_phase_plan(h, n_resized_rows, 4, 1)
    rows = sum(0 <= p_num * r + d < h
               for _, groups, n_phase in plans for r in range(n_phase) for d, _ in groups)
    return rows * sum(0 <= j + t - 1 < w for j in range(w) for t in range(4))


def bound_s(n_bytes: float, int8_ops: float, f32_ops: float = 0.0) -> Tuple[float, str]:
    """``(least seconds, what bounds it)``: the larger of the bytes over the
    memory rate and the operations over their peaks (int8 and float32
    summed)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---- the kernels of the full-width proton decode, as the program's H runs them ----

def kernel_b(rows: int) -> Tuple[float, float]:
    """Kernel B (Conv_0 as four parity phases, int8, bf16 out): ``(bytes, int8 ops)``."""
    h, w, cin, cout = 18, 10, 512, 256
    ops = 2 * rows * in_grid_taps(h, w) * cin * cout
    taps = sum(len(o) for o in PHASE_OFFSETS.values())
    n_bytes = (rows * h * w * cin + rows * 4 + taps * cin * cout + 4 * cout * 4 + cout * 4
               + rows * (2 * h - 1) * (2 * w - 1) * cout * 2)
    return n_bytes, ops


def kernel_d(rows: int) -> Tuple[float, float]:
    """Kernel D (the row-resize Conv_1 on the column-gathered grid, int8,
    bf16 out): ``(bytes, int8 ops)``."""
    h, w, cin, cout = 35, 30, 256, 128
    ops = 2 * rows * row_resize_taps(h, w, 56) * cin * cout
    _, _, plans = row_phase_plan(h, 56, 4, 1)
    n_groups = max(len(g) for _, g, _ in plans)
    n_bytes = (rows * h * w * cin + rows * 4 + len(plans) * n_groups * 4 * cin * cout
               + len(plans) * cout * 4 + cout * 4 + rows * 55 * w * cout * 2)
    return n_bytes, ops


def fused_decode(rows: int) -> Tuple[float, float, float]:
    """Kernel H (the decode after the MLP): ``(bytes, int8 ops, f32 ops)``
    for ``rows`` showers. int8: Conv_0's in-grid parity taps, Conv_1's 4x4
    taps on the resized 56x30 grid, Conv_2's 3x3 taps. f32: LN as 13 an
    element (mean 1, variance 3, normalise and affine 4, leaky 1, max 1,
    quantise 3), each GroupNorm with its quantise as 13 an element and each
    conv epilogue 3, GN_2 without the quantise 9, Conv_3 2 a tap, the output
    2 an element. Bytes: the bf16 input, every weight once, the f32 output."""
    f = 18 * 10 * 512
    i8 = 2 * rows * (in_grid_taps(18, 10) * 512 * 256 + pad1_taps(56, 30, 4) * 256 * 128
                     + pad1_taps(55, 29, 3) * 128 * 64)
    f32 = rows * (f * 13 + 35 * 19 * 256 * 16 + 55 * 29 * (128 * 16 + 64 * 12)
                  + 2 * pad1_taps(55, 29, 2) * 64 + 56 * 30 * 2)
    taps0 = sum(len(o) for o in PHASE_OFFSETS.values())
    weights = (2 * f * 4 + taps0 * 512 * 256 + 4 * 256 * 4 + 3 * 256 * 4
               + 16 * 256 * 128 + 4 * 128 * 4 + 9 * 128 * 64 + 4 * 64 * 4 + 4 * 64 * 4 + 4)
    n_bytes = rows * f * 2 + weights + rows * 56 * 30 * 4
    return n_bytes, i8, f32


# ---- the routed decode of one shower, layer by layer ----

def _router_ops(cfg) -> float:
    dims = [int(cfg["model.cond_dim"]), *cfg["model.router.widths"], int(cfg["model.n_experts"])]
    return 2.0 * sum(a * b for a, b in zip(dims, dims[1:]))


def _width(c: int, w: float) -> int:
    return max(32, int(c * w) // 32 * 32)


def decode_ops(cfg: Dict, precision: str) -> List[Tuple[str, float, str]]:
    """``(layer, operations, dtype)`` of one shower's routed decode: the
    router in float32, the generator's Dense layers and convs in the
    precision's dtypes (int8 convs where it quantises them, the float
    layers in its compute dtype; ``int8_fused`` runs Conv_3 in float32)."""
    arch = cfg["model.architecture"]
    w = float(cfg["model.generator.width"])
    nin = int(cfg["model.noise_dim"]) + int(cfg["model.cond_dim"])
    flt = "f32" if precision == "f32" else "bf16"
    i8 = "int8" if precision.startswith("int8") else flt
    out = [("router", _router_ops(cfg), "f32")]
    if arch == "proton":
        c0, c1, c2, c3 = (_width(c, w) for c in (512, 256, 128, 64))
        out += [("Dense_0", 2.0 * nin * 256, flt), ("Dense_1", 2.0 * 256 * c0 * 180, flt),
                ("Conv_0", 2.0 * in_grid_taps(18, 10) * c0 * c1, i8),
                ("Conv_1", 2.0 * pad1_taps(56, 30, 4) * c1 * c2, i8),
                ("Conv_2", 2.0 * pad1_taps(55, 29, 3) * c2 * c3, i8),
                ("Conv_3", 2.0 * pad1_taps(55, 29, 2) * c3,
                 "f32" if precision == "int8_fused" else flt)]
    elif arch == "neutron":
        c0, c1, c2, c3 = (_width(c, w) for c in (128, 256, 128, 64))
        out += [("Dense_0", 2.0 * nin * 256, flt), ("Dense_1", 2.0 * 256 * c0 * 169, flt),
                ("Conv_0", 2.0 * 24 * 24 * 4 * c0 * c1, i8),
                ("Conv_1", 2.0 * 46 * 46 * 4 * c1 * c2, i8),
                ("Conv_2", 2.0 * 45 * 45 * 4 * c2 * c3, i8),
                ("Conv_3", 2.0 * 44 * 44 * 4 * c3, flt)]
    else:
        raise ValueError(f"no decode count for the architecture {arch!r}")
    return out


def ideal_s_per_shower(cfg: Dict, precision: str) -> float:
    """Seconds one shower's routed decode needs at the peaks of its dtypes."""
    return sum(ops / PEAK[dtype] for _, ops, dtype in decode_ops(cfg, precision))


def int8_gemm_shapes(cfg: Dict, rows: int) -> List[Tuple[int, int, int]]:
    """``[M, K, N]`` of each int8 conv's per-tap GEMM when the plain int8
    path (one ``torch._int_mm`` a tap) decodes ``rows`` showers."""
    if cfg["model.architecture"] != "neutron":
        raise ValueError("the plain int8 GEMM shapes are counted for the neutron decode")
    w = float(cfg["model.generator.width"])
    c0, c1, c2, c3 = (_width(c, w) for c in (128, 256, 128, 64))
    return [(rows * 24 * 24, c0, c1), (rows * 46 * 46, c1, c2), (rows * 45 * 45, c2, c3)]
