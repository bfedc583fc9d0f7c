"""The launch plan of kernels A (``ln_leaky_rowquant``) and C
(``gn_leaky_rowquant``): ``decode_kernels.norm_quant_plan``, on the CPU.

On the card each sample of A and C runs on a thread-block cluster of k
blocks. The plan picks k, the threads and the dynamic shared memory of a
block for every shape the serve and the student ladder pass: Dense_1's width
F = 18 x 10 x C0 for A, and GroupNorm2d_0's 35 x 19 x C for C, at the
batch sizes a serve gives a kernel (1, a short last tile of 7, the 64-row
tile, and more than a wave).
"""

import pytest
import torch

from zdcsim_torch.ops import decode_kernels as dk

STUDENT_WS = (0.125, 0.1875, 0.25, 0.375, 0.5, 1.0)
LN_WIDTHS = tuple(int(11520 * w / 0.125) for w in STUDENT_WS)  # 11520 .. 92160
GN_CHANNELS = (32, 64, 128, 256)  # GroupNorm2d_0 of the students kernel C takes, and the teacher
BATCHES = (1, 7, 64, 261)
SHAPES = ([("ln", (f,), eb) for f in LN_WIDTHS for eb in (2, 4)]
          + [("gn", (35 * 19, c), eb) for c in GN_CHANNELS for eb in (2, 4)])


def _share_bytes(kind, sample, elem_bytes, k):
    """What a block of the cluster keeps: A its share of the row as f32 in
    16-element steps, C its ``ceil(HW / k)`` pixels as they lie."""
    if kind == "ln":
        return -(-(-(-sample[0] // k)) // 16) * 16 * 4
    hw, c = sample
    return -(-hw // k) * c * elem_bytes


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kind,sample,elem_bytes", SHAPES)
def test_plan_fits_a_block_and_fills_one_wave(kind, sample, elem_bytes, b):
    plan = dk.norm_quant_plan(kind, b, sample, elem_bytes)
    assert plan.k in dk.CLUSTER_SIZES
    assert plan.smem <= dk.SMEM_PER_BLOCK - 1024  # 227 KB less the static shared memory
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    fits = [k for k in dk.CLUSTER_SIZES if dk.norm_quant_plan(kind, b, sample, elem_bytes, k).kept]
    # every serving and student shape keeps its share at some k <= 8
    assert fits and plan.kept
    assert plan.smem >= _share_bytes(kind, sample, elem_bytes, plan.k)
    one_wave = [k for k in fits if b <= dk.ONE_WAVE_CLUSTERS[k]]
    if one_wave:
        # the b * k blocks are as many as one wave of clusters holds: no
        # larger k that fits would still run in one wave
        assert plan.k == max(one_wave)
        assert b * plan.k <= dk.N_SMS
        assert b * plan.k == max(b * k for k in one_wave)
    else:
        # more samples than one wave holds: the fewest blocks a sample
        assert plan.k == min(fits)
        assert b * plan.k >= dk.N_SMS


@pytest.mark.parametrize("kind,sample", [("ln", (92160,)), ("gn", (665, 256))])
def test_plan_at_the_serving_tile_is_the_sweeps_choice(kind, sample):
    """The sweep on the H100 (PERF.md, chip_smoke.py phase 9): bf16 at the
    64-row tile runs fastest at k = 2 (128 blocks, one wave), a tile of 7
    rows and a single row at k = 8."""
    assert dk.norm_quant_plan(kind, 64, sample, 2).k == 2
    assert dk.norm_quant_plan(kind, 7, sample, 2).k == 8
    assert dk.norm_quant_plan(kind, 1, sample, 2).k == 8


@pytest.mark.parametrize("kind,sample,elem_bytes", SHAPES)
def test_plan_is_the_same_on_every_call(kind, sample, elem_bytes):
    for b in BATCHES:
        first = dk.norm_quant_plan(kind, b, sample, elem_bytes)
        assert all(dk.norm_quant_plan(kind, b, sample, elem_bytes) == first for _ in range(3))
        assert dk.norm_quant_plan(kind, b, sample, elem_bytes, first.k) == first


@pytest.mark.parametrize("c", [48, 96])
def test_plan_refuses_the_channels_kernel_c_refuses(c):
    """C = 48 and 96, GroupNorm2d_0 of the w=0.1875 and w=0.375 students:
    C / 8 (6, 12) does not divide 128, so kernel C refuses them."""
    assert not dk.gn_channels_ok(c)
    with pytest.raises(ValueError, match="C/8"):
        dk.norm_quant_plan("gn", 64, (665, c), 2)


@pytest.mark.parametrize("k", [0, 3, 16])
def test_plan_refuses_other_cluster_sizes(k):
    with pytest.raises(ValueError, match="k must be one of"):
        dk.norm_quant_plan("ln", 64, (92160,), 2, k)
    with pytest.raises(ValueError, match="k must be one of"):
        dk.norm_quant_plan("gn", 64, (665, 256), 2, k)


def test_plan_streams_a_share_that_fits_no_cluster():
    """A 64 x 56 x 128 f32 sample (1.8 MB) or a row of 600000 does not fit
    a block's 227 KB at k = 8: the plan spreads it widest and streams."""
    for kind, sample in (("gn", (64 * 56, 128)), ("ln", (600000,))):
        plan = dk.norm_quant_plan(kind, 3, sample, 4)
        assert (plan.k, plan.kept) == (8, False)
        assert plan.smem <= dk.SMEM_PER_BLOCK - 1024


def test_wrappers_on_the_cpu_run_the_plain_versions_and_count_nothing():
    """A CPU tensor runs the plain version; no launch, no cluster launch."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn(3, 1000, generator=g)
    x = torch.randn(2, 5, 3, 64, generator=g)
    counts = [(w.launches, w.cluster_launches) for w in (dk.ln_leaky_rowquant,
                                                         dk.gn_leaky_rowquant)]
    for fn, plain, inp in ((dk.ln_leaky_rowquant, dk.ln_leaky_rowquant_plain, y),
                           (dk.gn_leaky_rowquant, dk.gn_leaky_rowquant_plain, x)):
        c = inp.shape[-1]
        scale, bias = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
        for got, want in zip(fn(inp, scale, bias), plain(inp, scale, bias)):
            assert torch.equal(got, want)
    assert counts == [(w.launches, w.cluster_launches) for w in (dk.ln_leaky_rowquant,
                                                                 dk.gn_leaky_rowquant)]
