"""The K-major weight packing and the K order of the int8 tensor-core convs
(``zdcsim_torch/csrc/conv_mma.cuh``, ``conv_mma_kernel``) that kernels B, D,
G and H run, on the CPU.

The kernel sums, for each output position, the K = taps x Cin products of
one implicit GEMM per phase: K in tap-major order, each tap's slab of Cin
bytes one shifted NHWC source pixel (zero off the grid) against the packed
weights ``[Cout, taps x Cin]``, phase p's taps starting at slab ``tap0[p]``.
``_plans``, ``_conv0_plan`` and ``_row_plan`` mirror the plans of the CUDA
sources (``conv0_plan``, ``pad1_plan``, kernel D's row phases); a float64
GEMM in that order over the packed weights must equal the plain versions'
sums bit for bit. Inputs are made with numpy from a seed. Each shape's
plain outputs are computed once and shared by its phases' cases
(``functools.cache``; no case writes to them).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zdcsim_torch.convert import from_state_dict, tree_to_torch
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.ops import decode_kernels as dk
from zdcsim_torch.ops import fused_decode_kernels as fdk


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _conv0_plan(h, w):
    """conv_mma.cuh ``conv0_plan(h, w, cout)``: Conv_0's four parity phases
    on an h x w source grid (kernel B, and G's Conv_0 at 18 x 10)."""
    return [dict(mh=h, mw=w, srs=1, kr=2 if pr else 3, kc=2 if pc else 3, dr0=-(pr == 0),
                 dc0=-(pc == 0), tap0=(0, 9, 15, 21)[2 * pr + pc], sr=2, pr=pr, sc=2, pc=pc)
            for pr in (0, 1) for pc in (0, 1)]


def _row_plan(offsets, n_rows, w):
    """The tensor-core plan of kernel D (``row_resize_conv4_int8.cu``): row
    phase p's output row r reads source rows 5 r + offsets[p][0] + a for its
    real groups a (the zero-padded group is skipped) and columns j - 1 ..
    j + 2; its slab starts at tap p * maxL * 4; it lands on row r * Q + p."""
    q, max_l = len(offsets), len(offsets[0])
    groups = dk.row_phase_groups(offsets)
    return [dict(mh=(n_rows - p + q - 1) // q, mw=w, srs=5, kr=groups[p], kc=4,
                 dr0=offsets[p][0], dc0=-1, tap0=p * max_l * 4, sr=q, pr=p, sc=1, pc=0)
            for p in range(q)]


def _plans(conv):
    """The kernel's ConvPhase list for ``conv`` (conv0_plan, fused_decode.cu
    pad1_plan): output positions mh x mw, kr x kc taps reading source
    offset (i * srs + dr0 + a, j + dc0 + t), the first tap's slab tap0, and
    the output map (i * sr + pr, j * sc + pc)."""
    if conv == 0:
        return _conv0_plan(18, 10)
    k = 4 if conv == 1 else 3
    return [dict(mh=55, mw=29, srs=1, kr=k, kc=k, dr0=-1, dc0=-1, tap0=0, sr=1, pr=0, sc=1,
                 pc=0)]


def _kernel_sums(xq, kp, ph):
    """The int8 sums of one phase as the kernel forms them: A [M, K] with K
    tap-major (tap (a, t), then Cin), B the phase's slab of the packed
    weights, summed as one float64 GEMM (exact: integers below 2**53).
    Returns ``[B, mh, mw, Cout]`` float64."""
    b, h, w, cin = xq.shape
    pad = 4  # more than any tap's reach past the grid
    xp = F.pad(xq.to(torch.float64), (0, 0, pad, pad, pad, pad))
    srs, rows = ph["srs"], ph["srs"] * (ph["mh"] - 1) + 1
    cols = []
    for a in range(ph["kr"]):
        for t in range(ph["kc"]):
            r0, c0 = pad + ph["dr0"] + a, pad + ph["dc0"] + t
            cols.append(xp[:, r0:r0 + rows:srs, c0:c0 + ph["mw"]].reshape(-1, cin))
    taps = ph["kr"] * ph["kc"]
    slab = kp[:, ph["tap0"] * cin:(ph["tap0"] + taps) * cin].to(torch.float64)
    return (torch.cat(cols, dim=1) @ slab.t()).reshape(b, ph["mh"], ph["mw"], -1)


def conv_inputs(conv, b, seed):
    """Seeded full-range int8 activations ``[b, *src]`` and logical int8
    weights, per-sample scales, weight scales and bias at conv ``conv``'s
    shapes, on the CPU (``tests/test_torch_gpu.py`` draws its inputs here
    too)."""
    rng = np.random.default_rng(seed)
    src, (_, _, cout), logical, sk_shape = fdk.CONVS[conv]
    xq = torch.from_numpy(rng.integers(-127, 128, (b, *src), dtype=np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, logical, dtype=np.int8))
    sx = torch.from_numpy(np.abs(rng.standard_normal(b)).astype(np.float32) * 0.01 + 1e-3)
    sk = torch.from_numpy(np.abs(rng.standard_normal(sk_shape)).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    return xq, kq, sx, sk, bias


@pytest.mark.parametrize("conv", [0, 1, 2, "narrow D"])
def test_pack_k_major_is_tap_major_and_unpacks(conv):
    """Tap-major K, and each 4 channels of a tap one little-endian 32-bit
    word (byte c = channel 4 wb + c), as the ``__dp4a`` bodies load them;
    at G's and H's convs and at D's layout at a narrow width."""
    if conv == "narrow D":
        logical = (8, 12, 12, 5)
        kq = torch.from_numpy(np.random.default_rng(7).integers(-127, 128, logical, dtype=np.int8))
    else:
        _, _, logical, _ = fdk.CONVS[conv]
        _, kq, _, _, _ = conv_inputs(conv, 1, conv)
    kp = dk.pack_k_major(kq)
    cin, cout = logical[-2:]
    taps = int(np.prod(logical[:-2]))
    assert kp.shape == (cout, taps * cin) and kp.dtype == torch.int8 and kp.is_contiguous()
    flat = kq.reshape(taps, cin, cout)
    rng = np.random.default_rng(3 if conv == "narrow D" else conv)
    for tap, c, n in zip(rng.integers(0, taps, 50), rng.integers(0, cin, 50),
                         rng.integers(0, cout, 50)):
        assert kp[n, tap * cin + c] == flat[tap, c, n]
    assert torch.equal(dk.unpack_k_major(kp, logical), kq)
    words = kp.numpy().view("<u4").reshape(cout, taps, cin // 4).astype(np.int64)
    u8 = flat.numpy().astype(np.uint8).astype(np.int64).reshape(taps, cin // 4, 4, cout)
    want = (u8 << (8 * np.arange(4)).reshape(1, 1, 4, 1)).sum(axis=2)
    assert np.array_equal(words, want.transpose(2, 0, 1))


@functools.cache
def _conv_case(conv):
    """``conv``'s inputs, its plain sums (``_conv_pad1_exact``, or Conv_0's
    ``up2_conv4_int8_plain`` at sx = sk = 1, bias = 0) and
    ``fused_conv_int8_plain``'s output."""
    xq, kq, sx, sk, bias = conv_inputs(conv, 2, 10 + conv)
    kp = dk.pack_k_major(kq)
    oh, ow, cout = fdk.CONVS[conv][1]
    if conv:
        ref = fdk._conv_pad1_exact(xq, kq, (oh, ow))
    else:
        ref = dk.up2_conv4_int8_plain(xq, torch.ones(2), kp, torch.ones((4, cout)),
                                      torch.zeros(cout), torch.float32)
    return (xq, kq, sx, sk, bias), kp, ref, fdk.fused_conv_int8_plain(conv, xq, sx, kp, sk, bias)


@pytest.mark.parametrize("conv,phase", [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (2, 0)])
def test_kernel_k_order_equals_the_plain_sums(conv, phase):
    """Conv_1 and Conv_2: equal to ``_conv_pad1_exact``; each Conv_0 phase:
    equal to ``up2_conv4_int8_plain``'s sums (sx = sk = 1, bias = 0) on that
    phase's output pixels, the odd phases' last row/column dropped. Through
    the f32 epilogue ``(f32(acc) * sk) * sx + bias`` they are
    ``fused_conv_int8_plain``'s output on those pixels."""
    (xq, kq, sx, sk, bias), kp, ref, out = _conv_case(conv)
    plans = _plans(conv)
    # the slabs tile K in phase order, and K covers every tap once
    assert [ph["tap0"] for ph in plans] == list(
        np.cumsum([0] + [ph["kr"] * ph["kc"] for ph in plans])[:-1])
    assert sum(ph["kr"] * ph["kc"] for ph in plans) * xq.shape[-1] == kp.shape[1]
    ph = plans[phase]
    sums = _kernel_sums(xq, kp, ph)
    oh, ow, cout = fdk.CONVS[conv][1]
    rows = torch.arange(ph["mh"]) * ph["sr"] + ph["pr"]
    cols = torch.arange(ph["mw"]) * ph["sc"] + ph["pc"]
    rk, ck = rows < oh, cols < ow
    got = sums[:, rk][:, :, ck]
    if conv:
        assert torch.equal(sums, ref)
    else:
        assert got.shape[1:3] == ((oh + 1 - ph["pr"]) // 2, (ow + 1 - ph["pc"]) // 2)
        assert torch.equal(got.to(torch.float32), ref[:, rows[rk]][:, :, cols[ck]])
    val = got.to(torch.float32) * (sk[phase] if conv == 0 else sk) * sx.reshape(-1, 1, 1, 1) + bias
    assert torch.equal(out[:, rows[rk]][:, :, cols[ck]], val)


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_fused_conv_int8_on_cpu_runs_the_plain_version(conv):
    """A CPU tensor runs the plain version and counts no launch."""
    xq, kq, sx, sk, bias = conv_inputs(conv, 2, 20 + conv)
    kp = dk.pack_k_major(kq)
    n0 = fdk.fused_conv_int8.launches
    out = fdk.fused_conv_int8(conv, xq, sx, kp, sk, bias)
    assert fdk.fused_conv_int8.launches == n0
    assert out.shape == (2, *fdk.CONVS[conv][1]) and out.dtype == torch.float32
    assert torch.equal(out, fdk.fused_conv_int8_plain(conv, xq, sx, kp, sk, bias))


def test_wrappers_refuse_weights_that_are_not_packed():
    torch.manual_seed(0)
    p = tree_to_torch(from_state_dict(Generator().state_dict()))
    front, tail = fdk.front_weights(p), fdk.tail_weights(p)
    assert tuple(front[2].shape) == (256, 12800)
    assert (tuple(tail[0].shape), tuple(tail[5].shape)) == ((128, 4096), (64, 1152))
    x = torch.zeros((1, 92160))
    logical0 = dk.unpack_k_major(front[2], (25, 512, 256)).contiguous()
    with pytest.raises(ValueError, match=r"kq0 must be \[256, 12800\]"):
        fdk.fused_decode_front(x, *front[:2], logical0, *front[3:])
    logical1 = dk.unpack_k_major(tail[0], (4, 4, 256, 128)).contiguous()
    with pytest.raises(ValueError, match=r"kq1 must be \[128, 4096\]"):
        fdk.fused_decode(x, *front, logical1, *tail[1:])
    with pytest.raises(ValueError, match=r"kq2 must be \[64, 1152\]"):
        fdk.fused_decode(x, *front, *tail[:5], tail[5].t(), *tail[6:])
    xq = torch.zeros((1, 55, 29, 128), dtype=torch.int8)
    sx = torch.ones(1)
    with pytest.raises(ValueError, match=r"kp must be \[64, 1152\]"):
        fdk.fused_conv_int8(2, xq, sx, tail[0], *tail[6:8])
    with pytest.raises(ValueError, match="conv must be one of"):
        fdk.fused_conv_int8(3, xq, sx, tail[5], *tail[6:8])
    with pytest.raises(ValueError, match=r"xq must be \[B, 56, 30, 256\]"):
        fdk.fused_conv_int8(1, xq, sx, tail[0], *tail[1:3])


# ---------------------------------------------------------------------------
# Kernels B and D on the same core, and their packed weights
# ---------------------------------------------------------------------------

def _b_inputs(b, h, w, cin, cout, seed):
    """Seeded int8 activations, kernel B's packed phase weights (the merged
    and quantized taps of a random 4x4 kernel), and f32 sx, sk, bias."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    kq, sk = dk._quant_phases(torch.from_numpy(
        rng.standard_normal((4, 4, cin, cout), dtype=np.float32)))
    sx = torch.from_numpy(np.abs(rng.standard_normal(b)).astype(np.float32) * 0.01 + 1e-3)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    return xq, dk.pack_k_major(kq), sx, sk, bias


def _d_inputs(b, w, cin, cout, seed):
    """As :func:`_b_inputs` for kernel D on the 35-row source grid: the
    packed row-phase weights of the 35 -> 56 plan and its offset table."""
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, 35, w, cin), dtype=np.int8))
    kq, sk, offsets = dk._quant_row_phases(torch.from_numpy(
        rng.standard_normal((4, 4, cin, cout), dtype=np.float32)), _row_phase_plan(35, 56, 4, 1)[2])
    sx = torch.from_numpy(np.abs(rng.standard_normal(b)).astype(np.float32) * 0.01 + 1e-3)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    return xq, dk.pack_k_major(kq), sx, sk, offsets, bias


@functools.cache
def _b_case(b, h, w, cin, cout):
    """Kernel B's inputs and ``up2_conv4_int8_plain``'s outputs: the sums (sx =
    sk = 1, bias = 0, f32), then f32 and bf16 through the epilogue."""
    xq, kp, sx, sk, bias = _b_inputs(b, h, w, cin, cout, 30 + cin)
    ref = dk.up2_conv4_int8_plain(xq, torch.ones(b), kp, torch.ones((4, cout)),
                                  torch.zeros(cout), torch.float32)
    return (xq, kp, sx, sk, bias), ref, {dt: dk.up2_conv4_int8_plain(xq, sx, kp, sk, bias, dt)
                                         for dt in (torch.float32, torch.bfloat16)}


@functools.cache
def _d_case(b, w, cin, cout):
    """As :func:`_b_case` for kernel D's ``row_resize_conv4_int8_plain``."""
    xq, kp, sx, sk, offsets, bias = _d_inputs(b, w, cin, cout, 40 + cin)
    ref = dk.row_resize_conv4_int8_plain(xq, torch.ones(b), kp, torch.ones((8, cout)), offsets,
                                         torch.zeros(cout), 56, torch.float32)
    return (xq, kp, sx, sk, offsets, bias), ref, {
        dt: dk.row_resize_conv4_int8_plain(xq, sx, kp, sk, offsets, bias, 56, dt)
        for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 18, 10, 512, 256), (2, 5, 3, 36, 70)])
def test_up2_k_order_equals_the_plain_sums(b, h, w, cin, cout, phase):
    """Kernel B at the teacher's width and at a narrow one: the phase's sums
    in the tensor-core K order over the packed weights equal
    ``up2_conv4_int8_plain``'s (sx = sk = 1, bias = 0) on the phase's pixels,
    and through the f32 epilogue its f32 and bf16 outputs."""
    (xq, kp, sx, sk, bias), ref, outs = _b_case(b, h, w, cin, cout)
    plans = _conv0_plan(h, w)
    assert sum(ph["kr"] * ph["kc"] for ph in plans) * cin == kp.shape[1]
    ph = plans[phase]
    sums = _kernel_sums(xq, kp, ph)
    rows = torch.arange(h) * 2 + ph["pr"]
    cols = torch.arange(w) * 2 + ph["pc"]
    rk, ck = rows < 2 * h - 1, cols < 2 * w - 1
    got = sums[:, rk][:, :, ck].to(torch.float32)
    assert torch.equal(got, ref[:, rows[rk]][:, :, cols[ck]])
    val = got * sk[phase] * sx.reshape(-1, 1, 1, 1) + bias
    for dt, out in outs.items():
        assert torch.equal(out[:, rows[rk]][:, :, cols[ck]], val.to(dt))


@pytest.mark.parametrize("phase", list(range(8)))
@pytest.mark.parametrize("b,w,cin,cout", [(1, 30, 256, 128), (2, 6, 8, 4)])
def test_row_resize_k_order_equals_the_plain_sums(b, w, cin, cout, phase):
    """Kernel D at the teacher's width and at a narrow one: the row phase's
    sums in the tensor-core K order (phase slab, group, column tap, channel;
    source row 5 r + d0 + a) over the packed weights equal
    ``row_resize_conv4_int8_plain``'s (sx = sk = 1, bias = 0) on the phase's
    rows, and through the f32 epilogue its f32 and bf16 outputs. The slabs
    tile K phase by phase, and the group the plan skips is all zero."""
    (xq, kp, sx, sk, offsets, bias), ref, outs = _d_case(b, w, cin, cout)
    plans = _row_plan(offsets, 55, w)
    max_l = len(offsets[0])
    assert [ph["tap0"] for ph in plans] == [4 * max_l * p for p in range(8)]
    assert 8 * max_l * 4 * cin == kp.shape[1]
    ph = plans[phase]
    skipped = kp[:, (ph["tap0"] + 4 * ph["kr"]) * cin:(ph["tap0"] + 4 * max_l) * cin]
    assert not skipped.any()
    sums = _kernel_sums(xq, kp, ph)
    assert sums.shape == (b, 7 if phase < 7 else 6, w, cout)
    got = sums.to(torch.float32)
    assert torch.equal(got, ref[:, phase::8])
    val = got * sk[phase] * sx.reshape(-1, 1, 1, 1) + bias
    for dt, out in outs.items():
        assert torch.equal(out[:, phase::8], val.to(dt))


def test_row_phase_table_is_contiguous():
    """The 35 -> 56 plan's merged row groups read consecutive source rows in
    every phase (phase 7 has 2 of 3 groups, padded with its first offset), so
    the tensor-core body reads them with a source-row stride; a table whose
    groups skip a row, or whose padding differs, is refused on the CPU too."""
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    _, _, offsets = dk._quant_row_phases(torch.ones((4, 4, 8, 4)),
                                         _row_phase_plan(35, 56, 4, 1)[2])
    groups = dk.row_phase_groups(offsets)
    assert groups == [3] * 7 + [2]
    assert [row[:n] for row, n in zip(offsets, groups)] == [
        [-1, 0, 1], [0, 1, 2], [0, 1, 2], [1, 2, 3], [2, 3, 4], [2, 3, 4], [3, 4, 5], [4, 5]]
    assert offsets[7] == [4, 5, 4]
    xq, kp, sx, sk, offsets, bias = _d_inputs(1, 6, 8, 4, 1)
    for bad in ([1, 3, 1], [1, 2, 0]):
        table = [list(row) for row in offsets]
        table[3] = bad
        with pytest.raises(ValueError, match="phase 3 must read consecutive source rows"):
            dk.row_resize_conv4_int8(xq, sx, kp, sk, table, bias, 56)


def test_b_and_d_refuse_weights_that_are_not_packed():
    """Both wrappers take the K-major ``[Cout, taps x Cin]`` weights only,
    and check it before the CPU branch."""
    xq, kp, sx, sk, bias = _b_inputs(1, 3, 2, 8, 4, 2)
    kq = dk.unpack_k_major(kp, (25, 8, 4)).contiguous()
    with pytest.raises(ValueError, match=r"kp must be \[Cout, 200\] int8"):
        dk.up2_conv4_int8(xq, sx, kq, sk, bias)
    with pytest.raises(ValueError, match=r"kp must be \[Cout, 200\] int8"):
        dk.up2_conv4_int8(xq, sx, kp.t(), sk, bias)
    xq, kp, sx, sk, offsets, bias = _d_inputs(1, 6, 8, 4, 3)
    kq = dk.unpack_k_major(kp, (8, 12, 8, 4)).contiguous()
    with pytest.raises(ValueError, match=r"kp must be \[Cout, 768\] int8"):
        dk.row_resize_conv4_int8(xq, sx, kq, sk, offsets, bias, 56)


def test_tensor_core_shape_rule_and_cpu_counts():
    """At the full-width teacher's convs (which the C entry points run on the
    tensor cores) and at a narrow width (``__dp4a``), a CPU call runs the
    plain version and counts no launch of either body."""
    counts = [(f.launches, f.mma_launches)
              for f in (dk.up2_conv4_int8, dk.row_resize_conv4_int8)]
    xq, kp, sx, sk, bias = _b_inputs(1, 18, 10, 512, 256, 4)
    assert torch.equal(dk.up2_conv4_int8(xq, sx, kp, sk, bias),
                       dk.up2_conv4_int8_plain(xq, sx, kp, sk, bias))
    xq, kp, sx, sk, bias = _b_inputs(2, 5, 3, 36, 70, 4)
    assert torch.equal(dk.up2_conv4_int8(xq, sx, kp, sk, bias),
                       dk.up2_conv4_int8_plain(xq, sx, kp, sk, bias))
    xq, kp, sx, sk, offsets, bias = _d_inputs(1, 30, 256, 128, 5)
    assert torch.equal(dk.row_resize_conv4_int8(xq, sx, kp, sk, offsets, bias, 56),
                       dk.row_resize_conv4_int8_plain(xq, sx, kp, sk, offsets, bias, 56))
    assert counts == [(f.launches, f.mma_launches)
                      for f in (dk.up2_conv4_int8, dk.row_resize_conv4_int8)]
