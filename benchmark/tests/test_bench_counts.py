"""The frozen counts reproduce the kernels' bounds that the port's records
give at 64 rows (H100 SXM peaks): B 0.0335 ms, D 0.0386 ms, H 0.1024 ms,
each bound by its operations; and the per-shower counts of the decode."""

from __future__ import annotations

import pytest
from counts import decode as d


@pytest.mark.parametrize("name, count, ms", [
    ("B", lambda: d.bound_s(*d.kernel_b(64)), 0.0335),
    ("D", lambda: d.bound_s(*d.kernel_d(64)), 0.0386),
    ("H", lambda: d.bound_s(*d.fused_decode(64)), 0.1024),
])
def test_kernel_bounds(name, count, ms):
    seconds, by = count()
    assert by == "operations"
    assert round(seconds * 1e3, 4) == ms


def test_tap_counts_by_hand():
    # 18x10 source grid: phase ee 52 x 28 in-grid taps, eo 52 x 18, oe 34 x 28, oo 34 x 18
    assert d.in_grid_taps(18, 10) == 52 * 28 + 52 * 18 + 34 * 28 + 34 * 18
    # 4x4 pad-1 taps on 56x30: rows 54 + 55 + 55 + 54, columns 28 + 29 + 29 + 28
    assert d.pad1_taps(56, 30, 4) == 218 * 114
    q, p, plans = d.row_phase_plan(35, 56, 4, 1)
    assert (q, p, len(plans)) == (8, 5, 8) and sum(n for _, _, n in plans) == 55


def test_decode_ops_per_shower():
    cfg = {"model.architecture": "proton", "model.generator.width": 1.0, "model.noise_dim": 10,
           "model.cond_dim": 9, "model.router.widths": [128, 64, 32], "model.n_experts": 3}
    ops = {name: (n, t) for name, n, t in d.decode_ops(cfg, "int8_fused")}
    assert ops["Dense_1"] == (2.0 * 256 * 92160, "bf16")
    # H's int8 operations of one row are the three convs' of the decode
    _, h_i8, _ = d.fused_decode(1)
    assert sum(n for n, t in ops.values() if t == "int8") == h_i8
    n = {name: n for name, n, _ in d.decode_ops({**cfg, "model.architecture": "neutron"}, "int8")}
    assert n["Conv_1"] == 2.0 * 46 * 46 * 4 * 256 * 128  # 2x2 distinct taps of the upsample
    assert d.int8_gemm_shapes({**cfg, "model.architecture": "neutron"}, 128)[1] == (
        128 * 46 * 46, 256, 128)
