"""The four norm stages of kernels G (``fused_decode_front``) and H
(``fused_decode``): launches 1, 3, 5 and 7 of ``csrc/fused_decode.cu`` (LN-quant,
GN_0-quant through the 35x19 -> 56x30 resize, GN_1-quant, GN_2 + Conv_3), which
run kernels A's and C's thread-block-cluster bodies (``csrc/norm_quant.cuh``).

On the CPU: each stage's launch plan (``fdk.stage_plan``) against a mirror of
the layout the C entry point checks it against; Python mirrors of the writers'
pixel ownership (``ResizeGrid``, ``Conv3Out``), as ``test_torch_fused_mma.py``
mirrors the convs' K order; the stage plain versions chained with the plain
convs against G's and H's plain versions and the chain they replaced, bit for
bit; the wrappers' CPU calls. On a card (marked ``gpu``, skipped here), each
stage kernel against its plain version. No JAX: the card's machine runs the
``gpu`` cases with ``--noconftest``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zdcsim_torch.convert import from_state_dict, tree_to_torch
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.ops import decode_kernels as dk
from zdcsim_torch.ops import fused_decode_kernels as fdk

ROWS = (1, 64, 128, 256, 1024)
STAGE_CASES = [(1, 2), (1, 4), (3, 4), (5, 4), (7, 4)]  # (stage, bytes of an input element)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _c_smem(stage, elem_bytes, k, threads):
    """``stage_smem`` of ``fused_decode.cu``: the dynamic shared memory of
    the stage's body at cluster size k (``ln_layout``, ``gn_layout``), which
    the entry point requires of a plan: A keeps its share of the row as f32
    in 16-element steps, C its ``ceil(HW / k)`` pixels as they lie beside
    ``4 (threads x 8 + 10 C)`` bytes of reduction space."""
    kind, sample, _ = fdk.NORM_STAGES[stage]
    if kind == "ln":
        share = -(-(-(-sample[0] // k)) // 16) * 16
        return share * 4 if share * 4 <= dk.MAX_DYN_SMEM else 0
    hw, c = sample
    fixed = 4 * (threads * 8 + 10 * c)
    keep = -(-hw // k) * c * elem_bytes
    return keep + fixed if keep + fixed <= dk.MAX_DYN_SMEM else fixed


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("stage,elem_bytes", STAGE_CASES)
def test_stage_plan_fits_a_block_and_is_the_same_on_every_call(stage, elem_bytes, rows):
    plan = fdk.stage_plan(stage, rows, elem_bytes)
    assert plan.k in dk.CLUSTER_SIZES
    assert plan.smem <= dk.SMEM_PER_BLOCK - 1024  # 227 KB less the static shared memory
    assert plan.smem == _c_smem(stage, elem_bytes, plan.k, plan.threads)
    assert all(fdk.stage_plan(stage, rows, elem_bytes) == plan for _ in range(3))
    assert fdk.stage_plan(stage, rows, elem_bytes, plan.k) == plan
    kind, sample, _ = fdk.NORM_STAGES[stage]
    generic = dk.norm_quant_plan(kind, rows, sample, elem_bytes)
    assert generic.kept  # every stage keeps its share at some k <= 8
    if stage in fdk.STREAM_K and rows > dk.ONE_WAVE_CLUSTERS[generic.k]:
        # GN_0 past one wave of kept clusters: streamed at k = 2, in one
        # wave up to 66 samples
        assert (plan.k, plan.kept) == (fdk.STREAM_K[stage], False)
        assert rows > 64 or rows * plan.k <= dk.N_SMS
    else:
        assert plan == generic and plan.kept


def test_stage_plans_at_the_serving_tile_are_the_sweeps_choice():
    """The sweep on the H100 (PERF.md, chip_smoke.py phase 9) at 64 rows:
    LN k = 2 kept (A's plan), GN_0 k = 2 streamed, GN_1 k = 4 kept over
    three waves, GN_2 + Conv_3 k = 2 kept."""
    x = torch.zeros((64, fdk.H0 * fdk.W0 * fdk.C0), dtype=torch.bfloat16)
    got = dict(zip(fdk.H_STAGES, fdk.stage_plans(fdk.H_STAGES, x)))
    assert {st: (p.k, p.kept) for st, p in got.items()} == {
        1: (2, True), 3: (2, False), 5: (4, True), 7: (2, True)}
    assert fdk.stage_plans(fdk.G_STAGES, x) == [got[1], got[3]]


@pytest.mark.parametrize("k", dk.CLUSTER_SIZES)
@pytest.mark.parametrize("stage,elem_bytes", STAGE_CASES)
def test_stage_plan_at_every_k_is_the_layout_the_entry_point_takes(stage, elem_bytes, k):
    plan = fdk.stage_plan(stage, 64, elem_bytes, k)
    assert plan.k == k and plan.smem == _c_smem(stage, elem_bytes, k, plan.threads)
    assert plan.smem <= dk.SMEM_PER_BLOCK - 1024


def test_f32_groupnorms_keep_a_share_only_at_k_4_and_above():
    """GN_0's f32 sample (665 KB) and GN_1's (798 KB) fit a block's 227 KB
    only at k >= 4; GN_2's (399 KB) at k = 2."""
    for stage, least in ((3, 4), (5, 4), (7, 2)):
        kept = [k for k in dk.CLUSTER_SIZES if fdk.stage_plan(stage, 64, 4, k).kept]
        assert kept == [k for k in dk.CLUSTER_SIZES if k >= least]


def _first_out_row(src, h, oh):
    """``first_out_row`` of ``norm_quant.cuh``: the first output row of an
    oh-row nearest resize of h rows whose source row is at least ``src``."""
    num = 2 * oh * src - h
    return 0 if num <= 0 else min(oh, -(-num // (2 * h)))


def _shares(hw, k):
    """Each rank's ``(pbeg, np)``: ``ceil(hw / k)`` pixels a block, as C's body."""
    share = -(-hw // k)
    return [(r * share, max(0, min(share, hw - r * share))) for r in range(k)]


def _resize_writes(k, h=fdk.H1, w=fdk.W1, oh=fdk.HG, ow=fdk.WG):
    """The writer ``ResizeGrid``: ``{rank: [(output pixel, source pixel)]}``
    that each block of a cluster writes: every source pixel of its share,
    quantised once, stored at the output rows ``first_out_row(sr) ..
    first_out_row(sr + 1) - 1`` x the columns likewise."""
    out = {}
    for rank, (pbeg, n) in enumerate(_shares(h * w, k)):
        out[rank] = []
        for src in range(pbeg, pbeg + n):
            sr, sc = divmod(src, w)
            for r in range(_first_out_row(sr, h, oh), _first_out_row(sr + 1, h, oh)):
                for col in range(_first_out_row(sc, w, ow), _first_out_row(sc + 1, w, ow)):
                    out[rank].append((r * ow + col, src))
    return out


@pytest.mark.parametrize("h,oh", [(fdk.H1, fdk.HG), (fdk.W1, fdk.WG), (35, 35), (29, 56)])
def test_first_out_row_is_the_first_row_mapped_at_or_past_a_source_row(h, oh):
    rows = np.floor((np.arange(oh) + 0.5) * h / oh).astype(np.int64)
    for src in range(h + 1):
        want = next((r for r in range(oh) if rows[r] >= src), oh)
        assert _first_out_row(src, h, oh) == want


@pytest.mark.parametrize("k", dk.CLUSTER_SIZES)
def test_resize_writes_every_output_pixel_exactly_once(k):
    """Each of the 56x30 output pixels is written by exactly one block of
    the cluster, from the source pixel of the nearest resize (the map of
    ``fdk._ROW_MAP``/``_COL_MAP``, JAX's)."""
    writes = [pw for rank in _resize_writes(k).values() for pw in rank]
    counts = np.bincount([po for po, _ in writes], minlength=fdk.HG * fdk.WG)
    assert counts.shape == (fdk.HG * fdk.WG,) and (counts == 1).all()
    want = (fdk._ROW_MAP[:, None] * fdk.W1 + fdk._COL_MAP[None, :]).reshape(-1)
    assert all(src == want[po] for po, src in writes)


def _conv3_computes(k, h=fdk.HV, w=fdk.WV):
    """The writer ``Conv3Out``: ``{rank: [(output pixel, [tap pixels])]}``
    that each block computes: the output rows anchored in its share's rows,
    keeping the pixels whose anchor (min(r, h - 1), min(col, w - 1)) lies
    in the share."""
    ow = w + 1
    out = {}
    for rank, (pbeg, n) in enumerate(_shares(h * w, k)):
        out[rank] = []
        if n <= 0:
            continue
        ra, rb = pbeg // w, (pbeg + n - 1) // w
        for po in range(ra * ow, (h + 1 if rb == h - 1 else rb + 1) * ow):
            r, col = divmod(po, ow)
            anchor = min(r, h - 1) * w + min(col, w - 1)
            if not pbeg <= anchor < pbeg + n:
                continue
            taps = [(r + a - 1) * w + col + c - 1 for a in range(2) for c in range(2)
                    if 0 <= r + a - 1 < h and 0 <= col + c - 1 < w]
            out[rank].append((po, anchor, taps))
    return out


@pytest.mark.parametrize("k", dk.CLUSTER_SIZES)
def test_conv3_computes_every_output_pixel_once_from_its_share_and_the_one_before(k):
    """Each of the 56x30 outputs of Conv_3 is computed by exactly one block;
    every tap it reads lies at or before its anchor and at most w + 1
    pixels before it, so in the block's share or the previous rank's, which
    the block reads from device memory."""
    done = _conv3_computes(k)
    counts = np.bincount([po for rank in done.values() for po, _, _ in rank],
                         minlength=fdk.HG * fdk.WG)
    assert counts.shape == (fdk.HG * fdk.WG,) and (counts == 1).all()
    shares = _shares(fdk.HV * fdk.WV, k)
    for rank, items in done.items():
        lo = shares[rank - 1][0] if rank else 0
        for po, anchor, taps in items:
            assert taps and all(anchor - fdk.WV - 1 <= t <= anchor and t >= lo for t in taps)


@pytest.fixture(scope="module")
def full_width():
    """A seeded full-width generator's tree, its front and tail weights, and
    the Dense_1 output of 2 rows (f32) made from numpy."""
    torch.manual_seed(0)
    p = tree_to_torch(from_state_dict(Generator().state_dict()))
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((2, fdk.H0 * fdk.W0 * fdk.C0), dtype=np.float32) * 2)
    return fdk.front_weights(p), fdk.tail_weights(p), x


def _old_chain(x, front, tail, apply_expm1):
    """G's and H's plain chains as they were before the stages had plain
    versions of their own: kernels A's and C's plain versions, the resize
    gather and Conv_3 in float64 written out."""
    ln_s, ln_b, kq0, sk0, b0, g0s, g0b = front
    kq1, sk1, b1, g1s, g1b, kq2, sk2, b2, g2s, g2b, k3, b3 = tail
    b = x.shape[0]
    xq, sx = dk.ln_leaky_rowquant_plain(x, ln_s, ln_b)
    y0 = fdk.fused_conv_int8_plain(0, xq.reshape(b, fdk.H0, fdk.W0, fdk.C0), sx, kq0, sk0, b0)
    q0, s0 = dk.gn_leaky_rowquant_plain(y0, g0s, g0b, fdk.GROUPS)
    q, s = fdk._gather_resize(q0), s0.reshape(b)
    y1 = fdk.fused_conv_int8_plain(1, q, s, kq1, sk1, b1)
    q2, s2 = dk.gn_leaky_rowquant_plain(y1, g1s, g1b, fdk.GROUPS)
    y2 = fdk.fused_conv_int8_plain(2, q2, s2, kq2, sk2, b2)
    yp = F.pad(dk.gn_leaky_plain(y2, g2s, g2b, fdk.GROUPS).to(torch.float64), (0, 0, 1, 1, 1, 1))
    acc = sum(yp[:, a:a + fdk.HG, c:c + fdk.WG] @ k3.to(torch.float64)[a, c]
              for a in range(2) for c in range(2))
    out = torch.relu(acc[..., 0].to(torch.float32) + b3)
    return (q, s), torch.expm1(out) if apply_expm1 else out


@pytest.mark.parametrize("apply_expm1", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_plains_chained_with_the_plain_convs_are_g_and_h_bit_for_bit(full_width, dtype,
                                                                            apply_expm1):
    front, tail, x = full_width
    x = x.to(dtype)
    ln_s, ln_b, kq0, sk0, b0, g0s, g0b = front
    kq1, sk1, b1, g1s, g1b, kq2, sk2, b2, g2s, g2b, k3, b3 = tail
    b = x.shape[0]
    xq, sx = fdk.fused_norm_stage_plain(1, x, ln_s, ln_b)
    y0 = fdk.fused_conv_int8_plain(0, xq.reshape(b, fdk.H0, fdk.W0, fdk.C0), sx, kq0, sk0, b0)
    q, s = fdk.fused_norm_stage_plain(3, y0, g0s, g0b)
    y1 = fdk.fused_conv_int8_plain(1, q, s, kq1, sk1, b1)
    q2, s2 = fdk.fused_norm_stage_plain(5, y1, g1s, g1b)
    y2 = fdk.fused_conv_int8_plain(2, q2, s2, kq2, sk2, b2)
    out = fdk.fused_norm_stage_plain(7, y2, g2s, g2b, k3, b3, apply_expm1)
    qg, sg = fdk.fused_decode_front_plain(x, *front)
    assert torch.equal(q, qg) and torch.equal(s, sg)
    assert q.shape == (b, fdk.HG, fdk.WG, fdk.C1) and s.shape == (b,)
    assert torch.equal(out, fdk.fused_decode_plain(x, *front, *tail, apply_expm1=apply_expm1))
    (q_old, s_old), out_old = _old_chain(x, front, tail, apply_expm1)
    assert torch.equal(q, q_old) and torch.equal(s, s_old) and torch.equal(out, out_old)
    assert out.shape == (b, fdk.HG, fdk.WG) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("stage,mb", [(1, 18.4), (3, 71.1), (5, 65.3), (7, 26.6)])
def test_chip_smoke_stage_bytes_at_the_serving_tile(stage, mb):
    """``chip_smoke.stage_bytes``, the byte floor of each stage in phase 9,
    at 64 rows: the input (bf16 for the LayerNorm), its parameters and the
    output (GN_0's on the 56x30 grid, Conv_3's one f32 channel)."""
    import chip_smoke

    x = torch.zeros((64, *fdk.NORM_STAGES[stage][2]),
                    dtype=torch.bfloat16 if stage == 1 else torch.float32)
    assert abs(chip_smoke.stage_bytes(stage, x) / 1e6 - mb) < 0.05


def _stage_inputs(stage, b, seed, dtype=torch.float32):
    """Seeded inputs of norm stage ``stage`` on ``b`` samples: x, scale, bias
    (and k3, b3 for stage 7), made with numpy."""
    rng = np.random.default_rng(seed)
    _, _, shape = fdk.NORM_STAGES[stage]
    n_par = shape[0] if stage == 1 else shape[-1]
    x = torch.from_numpy(rng.standard_normal((b, *shape), dtype=np.float32) * 2 + 0.3).to(dtype)
    scale = torch.from_numpy(np.abs(rng.standard_normal(n_par, dtype=np.float32)) + 0.5)
    bias = torch.from_numpy(rng.standard_normal(n_par, dtype=np.float32) * 0.3)
    if stage != 7:
        return x, scale, bias
    k3 = torch.from_numpy(rng.standard_normal((2, 2, fdk.C3, 1), dtype=np.float32) * 0.1)
    return x, scale, bias, k3, torch.from_numpy(rng.standard_normal(1, dtype=np.float32))


@pytest.mark.parametrize("stage", sorted(fdk.NORM_STAGES))
def test_norm_stage_on_cpu_runs_the_plain_version_and_counts_no_launch(stage):
    fn = fdk.fused_norm_stage
    n0 = (fn.launches, fn.cluster_launches)
    args = _stage_inputs(stage, 2, stage)
    got, want = fn(stage, *args), fdk.fused_norm_stage_plain(stage, *args)
    if stage == 7:
        assert torch.equal(got, want) and got.shape == (2, fdk.HG, fdk.WG)
        assert torch.equal(fn(stage, *args, apply_expm1=True), torch.expm1(got))
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0].dtype == torch.int8 and got[1].shape == (2,)
        out_shape = (fdk.HG, fdk.WG, fdk.C1) if stage == 3 else args[0].shape[1:]
        assert tuple(got[0].shape[1:]) == tuple(out_shape)
    assert (fn.launches, fn.cluster_launches) == n0


def test_norm_stage_refuses_what_the_entry_point_does_not_take():
    fn = fdk.fused_norm_stage
    x, scale, bias = _stage_inputs(3, 1, 0)
    with pytest.raises(ValueError, match="stage must be one of"):
        fn(2, x, scale, bias)
    with pytest.raises(ValueError, match=r"stage 3 takes x \[B, 35, 19, 256\] f32"):
        fn(3, x.to(torch.bfloat16), scale, bias)
    with pytest.raises(ValueError, match=r"stage 5 takes x \[B, 55, 29, 128\]"):
        fn(5, x, scale, bias)
    with pytest.raises(ValueError, match=r"scale and bias must be \[256\]"):
        fn(3, x, scale[:128], bias[:128])
    x7, s7, b7, k3, b3 = _stage_inputs(7, 1, 0)
    with pytest.raises(ValueError, match="stage 7 takes k3 and b3"):
        fn(7, x7, s7, b7)
    with pytest.raises(ValueError, match=r"k3 must be \[2, 2, 64, 1\]"):
        fn(7, x7, s7, b7, k3[:1], b3)
    with pytest.raises(ValueError, match="k must be one of"):
        fdk.stage_plan(3, 64, 4, 3)


def test_g_and_h_on_cpu_count_no_cluster_launch(full_width):
    front, tail, x = full_width
    g, h = fdk.fused_decode_front, fdk.fused_decode
    n0 = (g.launches, g.cluster_launches, h.launches, h.cluster_launches)
    g(x[:1], *front)
    h(x[:1], *front, *tail)
    assert (g.launches, g.cluster_launches, h.launches, h.cluster_launches) == n0


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_stage_on_card(stage, args, k=None):
    """The stage kernel against its plain version on the same card inputs,
    at kernels A's and C's bounds (stage 7 at H's int8 bound); a second
    launch bit-identical; both in clusters of the plan's k with its body."""
    fn = fdk.fused_norm_stage
    n0, c0 = fn.launches, fn.cluster_launches
    got, again = fn(stage, *args, k=k), fn(stage, *args, k=k)
    ref = fdk.fused_norm_stage_plain(stage, *args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.cluster_launches) == (n0 + 2, c0 + 2)
    if stage == 7:
        assert torch.equal(got, again) and got.shape == ref.shape
        assert (got - ref).abs().max().item() < 0.05 * ref.abs().max().item() + 0.05
        return
    (q, s), (q2, s2), (qp, sp) = got, again, ref
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert q.shape == qp.shape and q.dtype == torch.int8 and s.shape == sp.shape
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
    diff = (q.int() - qp.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("stage,dtype", [(1, torch.bfloat16), (1, torch.float32),
                                         (3, torch.float32), (5, torch.float32),
                                         (7, torch.float32)])
def test_norm_stage_kernel_matches_plain(cuda, stage, dtype, b):
    args = _stage_inputs(stage, b, 100 + stage, dtype)
    _check_stage_on_card(stage, [t.to(cuda) for t in args])


@pytest.mark.gpu
@pytest.mark.parametrize("k", dk.CLUSTER_SIZES)
@pytest.mark.parametrize("stage", sorted(fdk.NORM_STAGES))
def test_norm_stage_kernel_at_every_cluster_size(cuda, stage, k):
    """Every k, the streamed bodies (k = 1, and k = 2 for GN_0 and GN_1)
    among them, at 3 samples; GN_2 + Conv_3 writes its tap sums over its
    kept share, so the entry point refuses its streamed plan (k = 1)."""
    args = [t.to(cuda) for t in _stage_inputs(stage, 3, 200 + stage)]
    if not fdk.stage_plan(stage, 3, args[0].element_size(), k).kept and stage == 7:
        n0 = fdk.fused_norm_stage.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            fdk.fused_norm_stage(stage, *args, k=k)
        assert fdk.fused_norm_stage.launches == n0
        return
    _check_stage_on_card(stage, args, k=k)
