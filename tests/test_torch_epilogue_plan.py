"""The bulk body of kernels E (``expm1_channel_sums``) and F
(``routed_expm1_channel_sums``), on the CPU: which shapes it takes
(``epilogue_kernels.bulk_fits``), a model of its schedule and of its
row-half sums, and the launch counts of CPU calls.

On the card the bulk body copies whole showers into a ring in shared memory
with TMA bulk copies; a warp sums one shower by row halves, each with its
channel fixed. The CUDA source cannot run here, so the row-half
arithmetic and the grid's walk over the showers are modelled in numpy with
the kernel's index formulas and held against the channel masks.
"""

import numpy as np
import pytest
import torch

from zdcsim_torch.ops import epilogue_kernels as ek
from zdcsim_torch.ops.channels import get_channel_masks

SHAPES = [(56, 30), (44, 44)]  # the proton and the neutron showers
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w", SHAPES)
def test_bulk_fits_the_serving_and_neutron_showers(h, w, dtype):
    assert ek.bulk_fits(h, w, dtype, 1 << 20)
    # an offset view: 1 element past an aligned base
    assert not ek.bulk_fits(h, w, dtype, (1 << 20) + dtype.itemsize)


@pytest.mark.parametrize("h,w,dtype,fits", [
    (7, 5, torch.float32, False),    # 140 bytes: no multiple of 16
    (7, 5, torch.bfloat16, False),
    (8, 6, torch.float32, True),     # 192 bytes
    (8, 6, torch.bfloat16, True),    # 96 bytes
    (3, 5, torch.bfloat16, False),   # 30 bytes
    (128, 128, torch.float32, True),    # 64 KB, the largest shower it takes
    (128, 132, torch.float32, False),
    (256, 256, torch.float32, False),  # 2 showers of 256 KB do not fit a block
])
def test_bulk_fits_other_shapes(h, w, dtype, fits):
    assert ek.bulk_fits(h, w, dtype, 1 << 20) == fits


def schedule(b, grid, warps):
    """The kernel's walk with ``grid`` blocks of ``warps`` consumer warps:
    block ``blk``'s iteration i takes shower ``blk + i * grid``, slot
    ``i % (2 * warps)`` and consumer warp ``i % warps``. Returns
    ``{shower: (block, slot, warp)}`` and the slots each warp reads."""
    slots = 2 * warps
    seen, warp_slots = {}, {}
    for blk in range(grid):
        n_iter = (b - blk + grid - 1) // grid if blk < b else 0
        for i in range(n_iter):
            s = blk + i * grid
            assert s < b and s not in seen
            seen[s] = (blk, i % slots, i % warps)
            warp_slots.setdefault((blk, i % warps), set()).add(i % slots)
    return seen, warp_slots


@pytest.mark.parametrize("warps", [8, 1])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 5120, 16384])
def test_bulk_schedule_reads_every_shower_once(b, warps):
    """At the entry point's grid of min(B, one wave) blocks (one wave: 132
    SMs x 2 blocks) every shower is read once, the blocks' shares differ by
    at most one, and each consumer warp reads only its own 2 slots."""
    grid = min(b, 132 * 2)
    seen, warp_slots = schedule(b, grid, warps)
    assert sorted(seen) == list(range(b))
    shares = [sum(1 for blk, _, _ in seen.values() if blk == k) for k in range(grid)]
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    for (_, warp), slots in warp_slots.items():
        assert slots <= {warp, warp + warps}


def lane_runs(h, w, lane):
    """The runs of lane ``lane`` of the bulk body's warp on an ``[H, W]``
    shower, in its order: ``(row, first column, pixels)``. A run is a row
    half (row ``(lane >> 1) + 16k``, half ``lane & 1``); where ``H % 16 ==
    8`` the last 8 rows are cut into quarter rows, one a lane."""
    half = lane & 1
    c0, n = (w // 2, w - w // 2) if half else (0, w // 2)
    r0 = h // 16 * 16
    runs = [(r, c0, n) for r in range(lane >> 1, r0, 16)]
    if h % 16 == 8:
        sub = (lane >> 1) & 1
        runs.append((r0 + (lane >> 2), c0 + (n // 2 if sub else 0), n - n // 2 if sub else n // 2))
    elif r0 + (lane >> 1) < h:
        runs.append((r0 + (lane >> 1), c0, n))
    return runs


@pytest.mark.parametrize("h,w", SHAPES + [(8, 6), (4, 5), (2, 3), (24, 10), (40, 7), (16, 4)])
def test_lane_runs_cover_each_pixel_once_in_one_quadrant_column(h, w):
    seen = np.zeros((h, w), int)
    for lane in range(32):
        for r, c, m in lane_runs(h, w, lane):
            seen[r, c:c + m] += 1
            # even lanes take the left quadrant column, odd lanes the right
            assert all((col >= w // 2) == bool(lane & 1) for col in range(c, c + m))
    assert (seen == 1).all()


def row_half_model(x):
    """Kernel E's bulk body on one ``[H, W]`` shower in numpy float32: lane
    l of the warp sums each of its runs into two alternating sums, then adds
    them into its quadrant's and channel 4's sums; the lanes' sums are added
    in the kernel's xor-tree order."""
    h, w = x.shape
    v = np.expm1(x.astype(np.float32))
    lo, up, c4 = (np.zeros(32, np.float32) for _ in range(3))
    for lane in range(32):
        for r, c, m in lane_runs(h, w, lane):
            a = b = np.float32(0)
            for j in range(m):
                if j % 2 == 0:
                    a = np.float32(a + v[r, c + j])
                else:
                    b = np.float32(b + v[r, c + j])
            a_even = (r + c) % 2 == 0
            q = b if a_even else a
            c4[lane] = np.float32(c4[lane] + (a if a_even else b))
            if r >= h // 2:
                lo[lane] = np.float32(lo[lane] + q)
            else:
                up[lane] = np.float32(up[lane] + q)

    def tree(t, offsets):
        t = t.copy()
        for o in offsets:
            t = (t + t[np.arange(32) ^ o]).astype(np.float32)
        return t

    lo, up, c4 = (tree(t, (16, 8, 4, 2)) for t in (lo, up, c4))
    return np.array([lo[0], lo[1], up[0], up[1], c4[0] + c4[1]], np.float32)


@pytest.mark.parametrize("h,w", SHAPES + [(8, 6), (4, 5), (2, 3), (24, 10), (40, 7)])
def test_row_half_model_equals_the_channel_masks(h, w):
    """The bulk body's channel choice per row half gives the sums of
    ``zdcsim_torch.ops.channels``' masks (tolerance of
    tests/test_pallas_kernels.py: the sums run in another order)."""
    rng = np.random.default_rng(h * w)
    x = (rng.random((h, w), dtype=np.float32) * 4 - 0.5)
    masks = np.stack(get_channel_masks((h, w)))
    ref = (masks * np.expm1(x.astype(np.float64))).sum(axis=(1, 2))
    np.testing.assert_allclose(row_half_model(x), ref, rtol=1e-5, atol=0)


def test_cpu_calls_leave_the_launch_counts():
    """A CPU tensor runs the plain versions: no launch, no bulk launch."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.random((5, 56, 30), dtype=np.float32) * 3)
    imgs = torch.as_tensor(rng.random((3, 5, 56, 30), dtype=np.float32) * 3)
    idx = torch.tensor([0, 2, 1, -1, 2])
    counts = [(f.launches, f.bulk_launches)
              for f in (ek.expm1_channel_sums, ek.routed_expm1_channel_sums)]
    out = ek.expm1_channel_sums(x)
    routed = ek.routed_expm1_channel_sums(imgs, idx)
    assert counts == [(f.launches, f.bulk_launches)
                      for f in (ek.expm1_channel_sums, ek.routed_expm1_channel_sums)]
    assert torch.equal(out, ek.expm1_channel_sums_plain(x))
    assert torch.equal(routed.isnan(), ek.routed_expm1_channel_sums_plain(imgs, idx).isnan())
