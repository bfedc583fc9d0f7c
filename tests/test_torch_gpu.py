"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``; each test skips without a card. The repo's
``tests/conftest.py`` imports JAX, which the card's machine does not have,
so run this file there without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from zdcsim_torch.convert import from_state_dict, tree_to_torch
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.models.proton_fast import fast_generator_apply
from zdcsim_torch.ops import decode_kernels as dk

from test_torch_fused_mma import conv_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_norm_quant(fn, plain, args, kind, sample, s_rtol):
    """Kernel A or C against its plain version: s within ``s_rtol``, |q -
    q_plain| <= 1 with flips under 1% (the sums run in another order); a
    second launch bit-identical; both launches in clusters of the plan's k
    with the plan's body."""
    x = args[0]
    plan = dk.norm_quant_plan(kind, x.shape[0], sample, x.element_size())
    n0, c0 = fn.launches, fn.cluster_launches
    q, s = fn(*args)
    q2, s2 = fn(*args)
    qp, sp = plain(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.cluster_launches) == (n0 + 2, c0 + 2)
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == (x.shape[0], 1)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    torch.testing.assert_close(s, sp, rtol=s_rtol, atol=0)
    # bounds of tests/test_pallas_decode.py:36-44: the sums run in another order
    diff = (q.int() - qp.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f", [(b, f) for b in (1, 7, 64, 200)
                                 for f in (1000, 1001, 11520, 92160)] + [(3, 600000)])
def test_ln_leaky_rowquant_kernel_matches_plain(cuda, dtype, b, f):
    """1001, not a multiple of 4, runs one element a thread; 1000 splits
    into shares that F does not fill; 600000 does not fit a block's shared
    memory at k = 8 and streams."""
    rng = np.random.default_rng(b + f)
    y = torch.as_tensor(rng.standard_normal((b, f), dtype=np.float32) * 3).to(cuda, dtype)
    scale = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.5 + 1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.2).to(cuda)
    plan = check_norm_quant(dk.ln_leaky_rowquant, dk.ln_leaky_rowquant_plain, (y, scale, bias),
                            "ln", (f,), 1e-6)
    assert plan.kept == (f != 600000)


def exact_sum_inputs(rng, shape, dtype, cuda):
    """Small integers, each row of A's ``[B, F]`` made of pairs +v, -v: every
    sum of the kernels' statistics is exact in any order."""
    if len(shape) == 2:
        b, f = shape
        half = rng.integers(-8, 9, size=(b, f // 2))
        vals = rng.permuted(np.concatenate([half, -half], axis=1), axis=1)
    else:
        vals = rng.integers(-8, 9, size=shape)
    return torch.as_tensor(vals.astype(np.float32)).to(cuda, dtype)


def ieee_norm_quant(kind, x, scale, bias, groups=32):
    """A's or C's function in numpy float32, every operation rounded once as
    IEEE says (numpy's ``sqrt`` and ``/`` are; torch's CPU ``sqrt`` is not
    always): the reference for inputs whose sums are exact."""
    x = x.float().cpu().numpy()
    scale, bias = scale.cpu().numpy(), bias.cpu().numpy()
    b = x.shape[0]
    if kind == "ln":
        n = np.float32(x.shape[1])
        d = x - x.sum(1, keepdims=True, dtype=np.float32) / n
        rstd = np.float32(1) / np.sqrt((d * d).sum(1, keepdims=True, dtype=np.float32) / n
                                       + np.float32(1e-6))
        z = d * rstd * scale + bias
        axes = (1,)
    else:
        _, h, w, c = x.shape
        xg = x.reshape(b, h * w, groups, c // groups)
        n = np.float32(h * w * (c // groups))
        mu = xg.sum((1, 3), dtype=np.float32) / n
        var = np.maximum((xg * xg).sum((1, 3), dtype=np.float32) / n - mu * mu, np.float32(0))
        rstd = np.float32(1) / np.sqrt(var + np.float32(1e-6))
        z = ((xg - mu[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape) * scale + bias
        axes = (1, 2, 3)
    z = np.where(z >= 0, z, np.float32(0.1) * z)
    s = np.maximum(np.abs(z).max(axes).reshape(b, 1) / np.float32(127), np.float32(1e-12))
    q = np.clip(np.round(z / s.reshape((b,) + (1,) * (z.ndim - 1))), -127, 127).astype(np.int8)
    return q, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("kind,shape", [("ln", (92160,)), ("ln", (11520,)), ("ln", (1000,)),
                                        ("gn", (35, 19, 256)), ("gn", (35, 19, 32))])
def test_norm_quant_kernels_are_ieee_where_sums_are_exact(cuda, dtype, b, kind, shape):
    """On inputs whose sums are exact in any order, A and C equal the IEEE
    float32 reference bit for bit: this holds every rounding step, the
    quantise pass's division (a reciprocal and one FMA correction) among
    them, to IEEE's."""
    rng = np.random.default_rng([b, *shape])
    x = exact_sum_inputs(rng, (b, *shape), dtype, cuda)
    c = shape[-1]
    scale = torch.as_tensor(rng.standard_normal(c, dtype=np.float32) * 0.5 + 1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(c, dtype=np.float32) * 0.2).to(cuda)
    fn = dk.ln_leaky_rowquant if kind == "ln" else dk.gn_leaky_rowquant
    q, s = fn(x, scale, bias)
    q_ref, s_ref = ieee_norm_quant(kind, x, scale, bias)
    assert np.array_equal(s.cpu().numpy(), s_ref) and np.array_equal(q.cpu().numpy(), q_ref)


def test_ln_leaky_rowquant_kernel_takes_an_unaligned_view(cuda):
    """A contiguous view that starts 2 bytes into its storage runs the
    one-element path: no copy, the same bounds."""
    b, f = 5, 11520
    rng = np.random.default_rng(5)
    base = torch.as_tensor(rng.standard_normal(b * f + 1, dtype=np.float32) * 3).to(cuda, torch.bfloat16)
    y = base[1:].view(b, f)
    assert y.data_ptr() % 16
    scale = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.5 + 1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.2).to(cuda)
    check_norm_quant(dk.ln_leaky_rowquant, dk.ln_leaky_rowquant_plain, (y, scale, bias),
                     "ln", (f,), 1e-6)


@pytest.mark.parametrize("k", dk.CLUSTER_SIZES)
def test_norm_quant_kernels_match_plain_at_every_cluster_size(cuda, k):
    """Each cluster size of the sweep, at the serving tile of A and of C."""
    rng = np.random.default_rng(k)
    y = torch.as_tensor(rng.standard_normal((64, 92160), dtype=np.float32) * 3).to(cuda, torch.bfloat16)
    x = torch.as_tensor(rng.standard_normal((64, 35, 19, 256), dtype=np.float32) * 2 + 0.5
                        ).to(cuda, torch.bfloat16)
    for fn, plain, inp, rtol in ((dk.ln_leaky_rowquant, dk.ln_leaky_rowquant_plain, y, 1e-6),
                                 (dk.gn_leaky_rowquant, dk.gn_leaky_rowquant_plain, x, 1e-5)):
        c = inp.shape[-1]
        scale = torch.as_tensor(np.abs(rng.standard_normal(c, dtype=np.float32)) + 0.5).to(cuda)
        bias = torch.as_tensor(rng.standard_normal(c, dtype=np.float32) * 0.3).to(cuda)
        q, s = fn(inp, scale, bias, k=k)
        q2, s2 = fn(inp, scale, bias, k=k)
        qp, sp = plain(inp, scale, bias)
        torch.cuda.synchronize()
        assert torch.equal(q, q2) and torch.equal(s, s2)
        torch.testing.assert_close(s, sp, rtol=rtol, atol=0)
        diff = (q.int() - qp.int()).abs()
        assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01


def test_norm_quant_entry_points_refuse_other_cluster_sizes(cuda):
    """The C entry points refuse a k outside 1, 2, 4, 8 with
    cudaErrorInvalidValue (1) and launch nothing; the card holds clusters
    of every plan at the serving shapes."""
    import ctypes

    from zdcsim_torch.ops import _build

    lib = _build.library()
    y = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda)
    x = torch.zeros((2, 5, 3, 64), dtype=torch.bfloat16, device=cuda)
    par = torch.ones(64, device=cuda)
    q = torch.empty((2, 64), dtype=torch.int8, device=cuda)
    s = torch.empty(2, device=cuda)
    ck, kept = ctypes.c_int(-1), ctypes.c_int(-1)
    for k in (0, 3, 16):
        st = lib.zdc_ln_leaky_rowquant(y.data_ptr(), 1, par.data_ptr(), par.data_ptr(),
                                       q.data_ptr(), s.data_ptr(), 2, 64, k, 32,
                                       ctypes.addressof(ck), ctypes.addressof(kept), 0)
        assert (st, ck.value) == (1, 0)
        st = lib.zdc_gn_leaky_rowquant(x.data_ptr(), 1, par.data_ptr(), par.data_ptr(),
                                       q.data_ptr(), s.data_ptr(), 2, 15, 64, 32, k, 512,
                                       ctypes.addressof(ck), ctypes.addressof(kept), 0)
        assert (st, ck.value) == (1, 0)
    for kind, sample in (("ln", (92160,)), ("ln", (11520,)), ("gn", (665, 256)), ("gn", (665, 32))):
        for b in (1, 7, 64):
            k = dk.norm_quant_plan(kind, b, sample, 2).k
            assert dk.norm_quant_max_clusters(kind, torch.bfloat16, sample, k) > 0


@pytest.mark.parametrize("b,h,w,cin,cout", [(4, 6, 4, 16, 8), (2, 5, 3, 36, 70),
                                            (1, 18, 10, 512, 256), (7, 18, 10, 512, 256),
                                            (64, 18, 10, 512, 256)])
def test_up2_conv4_int8_kernel_matches_plain(cuda, b, h, w, cin, cout):
    """Kernel B equals its plain version bit for bit in f32 and bf16: on the
    int8 tensor cores at the teacher's 512 -> 256, on ``__dp4a`` at the
    narrow widths."""
    rng = np.random.default_rng(cin + cout)
    xq = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(cuda)
    sx = torch.as_tensor(np.abs(rng.standard_normal(b)).astype(np.float32) * 0.01 + 1e-3).to(cuda)
    kernel = torch.as_tensor(rng.standard_normal((4, 4, cin, cout), dtype=np.float32) * 0.1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(cout, dtype=np.float32) * 0.5).to(cuda)
    kq, sk = dk._quant_phases(kernel)
    kp = dk.pack_k_major(kq)
    mma = cin == 512
    n0, m0 = dk.up2_conv4_int8.launches, dk.up2_conv4_int8.mma_launches
    for dt in (torch.float32, torch.bfloat16):
        out = dk.up2_conv4_int8(xq, sx, kp, sk, bias, out_dtype=dt)
        ref = dk.up2_conv4_int8_plain(xq, sx, kp, sk, bias, out_dtype=dt)
        torch.cuda.synchronize()
        assert out.shape == (b, 2 * h - 1, 2 * w - 1, cout) and out.dtype == dt
        assert torch.equal(out, ref)
    assert dk.up2_conv4_int8.launches == n0 + 2
    assert dk.up2_conv4_int8.mma_launches == m0 + (2 if mma else 0)


def test_up2_conv4_int8_rejects_cin_not_multiple_of_4(cuda):
    xq = torch.zeros((1, 4, 4, 6), dtype=torch.int8, device=cuda)
    kq = torch.zeros((25, 6, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        dk.up2_conv4_int8(xq, torch.ones(1, device=cuda), dk.pack_k_major(kq),
                          torch.ones((4, 8), device=cuda), torch.zeros(8, device=cuda))


def test_fast_generator_pallas_ab_card_matches_cpu(cuda):
    """The pallas_ab decode with the kernels on the card against the same
    decode on the CPU (plain versions), on a narrow random generator."""
    torch.manual_seed(0)
    params = from_state_dict(Generator(width=1 / 16).state_dict())
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.standard_normal((8, 10), dtype=np.float32))
    cond = torch.as_tensor(rng.standard_normal((8, 9), dtype=np.float32))
    ref = fast_generator_apply(tree_to_torch(params), noise, cond, int8=True,
                               int8_backend="pallas_ab").numpy()
    out = fast_generator_apply(tree_to_torch(params, device=cuda), noise.to(cuda), cond.to(cuda),
                               int8=True, int8_backend="pallas_ab").cpu().numpy()
    # int8 bound of tests/test_pallas_decode.py:203 (rounding flips cascade)
    assert np.abs(out - ref).max() < 0.05 * np.abs(ref).max() + 0.05


@pytest.mark.parametrize("b", [1, 7, 64, 200])
@pytest.mark.parametrize("dtype,h,w,c", [(torch.bfloat16, 35, 19, 256), (torch.float32, 35, 19, 256),
                                         (torch.bfloat16, 35, 19, 32), (torch.float32, 5, 3, 64),
                                         (torch.float32, 64, 56, 128)])
def test_gn_leaky_rowquant_kernel_matches_plain(cuda, dtype, b, h, w, c):
    """A 64x56x128 f32 sample (1.8 MB) does not fit a block's shared memory
    at k = 8 and streams."""
    rng = np.random.default_rng(b + c)
    x = torch.as_tensor(rng.standard_normal((b, h, w, c), dtype=np.float32) * 2 + 0.5).to(cuda, dtype)
    scale = torch.as_tensor(np.abs(rng.standard_normal(c, dtype=np.float32)) + 0.5).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(c, dtype=np.float32) * 0.3).to(cuda)
    plan = check_norm_quant(dk.gn_leaky_rowquant, dk.gn_leaky_rowquant_plain, (x, scale, bias),
                            "gn", (h * w, c), 1e-5)
    assert plan.kept == (h * w * c * x.element_size() < 1 << 20)


@pytest.mark.parametrize("b,w,cin,cout", [(2, 6, 8, 4), (65, 30, 256, 128), (3, 30, 32, 32),
                                          (1, 30, 256, 128), (7, 30, 256, 128),
                                          (64, 30, 256, 128)])
def test_row_resize_conv4_int8_kernel_matches_plain(cuda, b, w, cin, cout):
    """Exact in f32 and bf16: on the int8 tensor cores at the teacher's 256 ->
    128, on ``__dp4a`` at the narrow widths; 65 samples x 7 rows x 30 columns
    is not a multiple of a block's rows."""
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    rng = np.random.default_rng(cin + cout + b)
    xq = torch.as_tensor(rng.integers(-127, 128, (b, 35, w, cin), dtype=np.int8)).to(cuda)
    sx = torch.as_tensor(np.abs(rng.standard_normal(b)).astype(np.float32) * 0.01 + 1e-3).to(cuda)
    kernel = torch.as_tensor(rng.standard_normal((4, 4, cin, cout), dtype=np.float32) * 0.1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(cout, dtype=np.float32) * 0.5).to(cuda)
    kq, sk, offsets = dk._quant_row_phases(kernel, _row_phase_plan(35, 56, 4, 1)[2])
    kp = dk.pack_k_major(kq)
    mma = cin == 256
    n0 = dk.row_resize_conv4_int8.launches
    m0 = dk.row_resize_conv4_int8.mma_launches
    for dt in (torch.float32, torch.bfloat16):
        out = dk.row_resize_conv4_int8(xq, sx, kp, sk, offsets, bias, 56, out_dtype=dt)
        ref = dk.row_resize_conv4_int8_plain(xq, sx, kp, sk, offsets, bias, 56, out_dtype=dt)
        torch.cuda.synchronize()
        assert out.shape == (b, 55, w, cout) and out.dtype == dt
        assert torch.equal(out, ref)
    assert dk.row_resize_conv4_int8.launches == n0 + 2
    assert dk.row_resize_conv4_int8.mma_launches == m0 + (2 if mma else 0)


def test_row_resize_conv4_int8_rejects_other_plans(cuda):
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    kq, sk, offsets = dk._quant_row_phases(torch.randn(4, 4, 8, 8, device=cuda),
                                           _row_phase_plan(35, 56, 4, 1)[2])
    xq = torch.zeros((1, 19, 30, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="stride-5"):
        dk.row_resize_conv4_int8(xq, torch.ones(1, device=cuda), dk.pack_k_major(kq), sk,
                                 offsets, torch.zeros(8, device=cuda), 30)


@pytest.mark.parametrize("b,h,w,cin,cout,k", [(2, 56, 30, 256, 128, 4), (2, 55, 29, 128, 64, 3),
                                              (3, 56, 30, 32, 32, 4)])
def test_conv_i8_is_exact_on_the_card(cuda, b, h, w, cin, cout, k):
    """int32 sums on the card equal the CPU's (which tests/test_torch_conv_i8.py
    holds bit-equal to JAX and to an int64 direct sum), at the extreme values
    where a float32 sum would round."""
    from zdcsim_torch.models.proton_fast import _conv_i8

    rng = np.random.default_rng(cin)
    xq = torch.as_tensor(np.where(rng.random((b, h, w, cin)) < 0.01, -127, 127).astype(np.int8))
    kq = torch.as_tensor(np.where(rng.random((k, k, cin, cout)) < 0.01, -127, 127).astype(np.int8))
    ref = _conv_i8(xq, kq, ((1, 1), (1, 1)))
    out = _conv_i8(xq.to(cuda), kq.to(cuda), ((1, 1), (1, 1)))
    assert out.dtype == torch.int32
    assert torch.equal(out.cpu(), ref)


def test_fast_generator_pallas_card_matches_cpu(cuda):
    """The pallas decode with all four kernels on the card against the same
    decode on the CPU (plain versions), on a narrow random generator."""
    torch.manual_seed(1)
    params = from_state_dict(Generator(width=1 / 16).state_dict())
    rng = np.random.default_rng(1)
    noise = torch.as_tensor(rng.standard_normal((8, 10), dtype=np.float32))
    cond = torch.as_tensor(rng.standard_normal((8, 9), dtype=np.float32))
    ref = fast_generator_apply(tree_to_torch(params), noise, cond, int8=True,
                               int8_backend="pallas").numpy()
    n0 = (dk.gn_leaky_rowquant.launches, dk.row_resize_conv4_int8.launches)
    m0 = (dk.up2_conv4_int8.mma_launches, dk.row_resize_conv4_int8.mma_launches)
    out = fast_generator_apply(tree_to_torch(params, device=cuda), noise.to(cuda), cond.to(cuda),
                               int8=True, int8_backend="pallas").cpu().numpy()
    assert (dk.gn_leaky_rowquant.launches, dk.row_resize_conv4_int8.launches) == (n0[0] + 1, n0[1] + 1)
    # the narrow generator's convs run the __dp4a bodies
    assert (dk.up2_conv4_int8.mma_launches, dk.row_resize_conv4_int8.mma_launches) == m0
    # int8 bound of tests/test_pallas_decode.py:203 (rounding flips cascade)
    assert np.abs(out - ref).max() < 0.05 * np.abs(ref).max() + 0.05


@pytest.mark.parametrize("dtype,b,h,w", [(torch.float32, 10, 8, 6), (torch.float32, 37, 44, 44),
                                         (torch.bfloat16, 9, 7, 5)])
def test_expm1_channel_sums_kernel_matches_plain(cuda, dtype, b, h, w):
    """Kernel E; 7x5 has odd sides and 35 pixels (the scalar-load path of
    the direct body: 70 bytes of bf16 are no multiple of 16), 8x6 and 44x44 f32
    take the bulk body."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(b + h + w)
    x = torch.as_tensor(rng.random((b, h, w), dtype=np.float32) * 3).to(cuda, dtype)
    n0, k0 = ek.expm1_channel_sums.launches, ek.expm1_channel_sums.bulk_launches
    out = ek.expm1_channel_sums(x)
    ref = ek.expm1_channel_sums_plain(x)
    torch.cuda.synchronize()
    assert ek.expm1_channel_sums.launches == n0 + 1
    assert ek.expm1_channel_sums.bulk_launches == k0 + ek.bulk_fits(h, w, dtype, x.data_ptr())
    assert out.shape == (b, 5) and out.dtype == torch.float32
    # tolerance of tests/test_pallas_kernels.py (sums taken in another order)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("e,b,h,w", [(3, 8, 8, 6), (3, 37, 56, 30), (2, 5, 7, 5)])
def test_routed_expm1_channel_sums_kernel_matches_plain_and_e(cuda, e, b, h, w):
    """Kernel F against its plain version, and bit-equal to kernel E on the
    routed rows (one device function reads both)."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(e + b + h)
    imgs = torch.as_tensor(rng.random((e, b, h, w), dtype=np.float32) * 3).to(cuda)
    idx = torch.as_tensor(rng.integers(0, e, b)).to(cuda)
    n0 = ek.routed_expm1_channel_sums.launches
    out = ek.routed_expm1_channel_sums(imgs, idx)
    ref = ek.routed_expm1_channel_sums_plain(imgs, idx)
    rows = ek.expm1_channel_sums(imgs[idx, torch.arange(b, device=cuda)].contiguous())
    torch.cuda.synchronize()
    assert ek.routed_expm1_channel_sums.launches == n0 + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    assert torch.equal(out, rows)


def test_routed_expm1_channel_sums_writes_nan_for_a_bad_id(cuda):
    """On the bulk body: a bad id issues no copy and gets NaN sums."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(5)
    imgs = torch.as_tensor(rng.random((3, 6, 56, 30), dtype=np.float32)).to(cuda)
    idx = torch.tensor([0, -1, 2, 3, 1, 1 << 40], device=cuda)
    k0 = ek.routed_expm1_channel_sums.bulk_launches
    out = ek.routed_expm1_channel_sums(imgs, idx)
    assert ek.routed_expm1_channel_sums.bulk_launches == k0 + 1
    ref = ek.routed_expm1_channel_sums_plain(imgs, idx)
    torch.cuda.synchronize()
    bad = torch.tensor([False, True, False, True, False, True], device=cuda)
    assert torch.isnan(out[bad]).all() and torch.isnan(ref[bad]).all()
    assert torch.isfinite(out[~bad]).all()
    torch.testing.assert_close(out[~bad], ref[~bad], rtol=1e-5, atol=0)


BULK_SHAPES = [(56, 30), (44, 44)]  # the proton and the neutron showers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", BULK_SHAPES)
@pytest.mark.parametrize("b", [1, 7, 9, 5120, 16387])
def test_expm1_bulk_body_matches_plain_and_its_rerun(cuda, b, h, w, dtype):
    """Kernel E's bulk body: 1, 7 and 9 showers run fewer blocks than a
    wave, 5120 and 16387 more showers than blocks, so every block's ring of
    16 slots wraps (16387 leaves the blocks uneven shares); a rerun gives
    the same bits."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(b + h)
    x = torch.as_tensor(rng.random((b, h, w), dtype=np.float32) * 4 - 0.5).to(cuda, dtype)
    assert ek.bulk_fits(h, w, dtype, x.data_ptr())
    n0, k0 = ek.expm1_channel_sums.launches, ek.expm1_channel_sums.bulk_launches
    out = ek.expm1_channel_sums(x)
    again = ek.expm1_channel_sums(x)
    ref = ek.expm1_channel_sums_plain(x)
    torch.cuda.synchronize()
    assert ek.expm1_channel_sums.launches == n0 + 2
    assert ek.expm1_channel_sums.bulk_launches == k0 + 2
    assert torch.equal(out, again)
    # tolerance of tests/test_pallas_kernels.py (sums taken in another order)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expm1_offset_view_takes_the_direct_body(cuda, dtype):
    """A view 1 element past an aligned base cannot be bulk-copied: it takes
    the direct body and is still right; so does the debug switch to that body."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    b, h, w = 37, 56, 30
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.random(b * h * w + 1, dtype=np.float32) * 3).to(cuda, dtype)
    x = flat[1:].view(b, h, w)
    assert not ek.bulk_fits(h, w, dtype, x.data_ptr())
    k0 = ek.expm1_channel_sums.bulk_launches
    out = ek.expm1_channel_sums(x)
    old = ek.expm1_channel_sums(x.clone(), _direct_body=True)
    ref = ek.expm1_channel_sums_plain(x)
    torch.cuda.synchronize()
    assert ek.expm1_channel_sums.bulk_launches == k0
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(old, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [9, 5120])
def test_routed_bulk_body_equals_e_on_routed_rows(cuda, b, dtype):
    """Kernel F's bulk body against its plain version and bit-equal to E's on
    the routed rows; its bad ids (every 7th shower) give NaN."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(b)
    imgs = torch.as_tensor(rng.random((3, b, 56, 30), dtype=np.float32) * 4 - 0.5).to(cuda, dtype)
    ids = rng.integers(0, 3, b)
    ids[::7] = -1
    idx = torch.as_tensor(ids).to(cuda)
    bad = idx < 0
    f0, e0 = ek.routed_expm1_channel_sums.bulk_launches, ek.expm1_channel_sums.bulk_launches
    out = ek.routed_expm1_channel_sums(imgs, idx)
    ref = ek.routed_expm1_channel_sums_plain(imgs, idx)
    rows = ek.expm1_channel_sums(imgs[idx.clamp(min=0), torch.arange(b, device=cuda)].contiguous())
    torch.cuda.synchronize()
    assert ek.routed_expm1_channel_sums.bulk_launches == f0 + 1
    assert ek.expm1_channel_sums.bulk_launches == e0 + 1
    assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()
    torch.testing.assert_close(out[~bad], ref[~bad], rtol=1e-5, atol=0)
    assert torch.equal(out[~bad], rows[~bad])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", BULK_SHAPES)
def test_bulk_grid_on_the_card_is_one_wave(cuda, h, w, dtype):
    """The grid that E's C entry reports for the bulk body: one block a
    shower below a wave, and one wave (a whole number of blocks on each SM,
    at least one) at 16384 showers, the same on a rerun."""
    from zdcsim_torch.ops import _build
    from zdcsim_torch.ops import epilogue_kernels as ek

    def grid(b):
        x = torch.zeros((b, h, w), dtype=dtype, device=cuda)
        out = torch.empty((b, 5), device=cuda)
        return ek._launch(_build.library().zdc_expm1_channel_sums, x, (out.data_ptr(), b, h, w),
                          False, "expm1_channel_sums")

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    wave = grid(16384)
    torch.cuda.synchronize()
    assert wave >= sms and wave % sms == 0 and grid(16384) == wave
    assert [grid(b) for b in (1, 7, 9)] == [1, 7, 9]


def test_fastsim_f32_is_float32_on_the_card(cuda):
    """``FastSim(precision="f32")`` on the card against the CPU, on a narrow
    random generator: float32 agrees to 1e-4 in log space, and the same
    decode with cuDNN's TF32 on (torch's default for convs) does not, so the
    bound can tell the two apart."""
    from zdcsim_torch.convert import expert, from_jax_params
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.router import RouterNetwork
    from zdcsim_torch.utils.artifact import _flatten, _unflatten

    torch.manual_seed(2)
    trees = [_flatten(from_state_dict(Generator(width=1 / 16).state_dict())) for _ in range(3)]
    gen = _unflatten({k: np.stack([t[k] for t in trees]) for k in trees[0]})
    router = from_state_dict(RouterNetwork(3).state_dict())
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((16, 9), dtype=np.float32)
    noise = rng.standard_normal((16, 10), dtype=np.float32)
    ref = FastSim(gen, router, batch_size=16, device="cpu").simulate_switch(cond, noise=noise)
    out = FastSim(gen, router, batch_size=16, device=cuda).simulate_switch(cond, noise=noise)
    err = (torch.log1p(out.cpu()) - torch.log1p(ref)).abs().max().item()
    assert err < 1e-4, err

    p0 = tree_to_torch(expert(from_jax_params(gen, router)[0], 0), device=cuda)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = fast_generator_apply(p0, torch.as_tensor(noise).to(cuda),
                                    torch.as_tensor(cond).to(cuda))
    f32 = fast_generator_apply(tree_to_torch(expert(from_jax_params(gen, router)[0], 0)),
                               torch.as_tensor(noise), torch.as_tensor(cond))
    assert (tf32.cpu() - f32).abs().max().item() > 1e-4


@pytest.fixture(scope="module")
def teacher_expert1():
    """Expert 1 of the full-width teacher, as the engine holds it (bf16 on
    the card), and its G and H weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from zdcsim_torch.convert import expert, from_jax_params
    from zdcsim_torch.ops import fused_decode_kernels as fdk
    from zdcsim_torch.utils.artifact import load_serving_artifact

    path = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                        "gate_serving_weights.npz")
    gp = load_serving_artifact(path)[0]
    p = tree_to_torch(expert(from_jax_params(gp, {})[0], 1), dtype=torch.bfloat16,
                      device=torch.device("cuda"))
    return p, fdk.front_weights(p), fdk.tail_weights(p)


def _dense1(p, b):
    from zdcsim_torch.models.proton_fast import mlp_apply

    rng = np.random.default_rng(b)
    noise, cond = (torch.as_tensor(rng.standard_normal((b, n), dtype=np.float32))
                   .to("cuda", torch.bfloat16) for n in (10, 9))
    with torch.no_grad():
        return mlp_apply(p, noise, cond)


@pytest.mark.parametrize("b,dtype", [(1, torch.bfloat16), (7, torch.float32),
                                     (64, torch.bfloat16)])
def test_fused_decode_front_kernel_matches_plain(teacher_expert1, b, dtype):
    """Kernel G, under the bounds of chip_smoke.py phase 7b (those of kernel
    C: the statistics are summed in another order)."""
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    p, front, _ = teacher_expert1
    x = _dense1(p, b).to(dtype)
    n0 = fdk.fused_decode_front.launches
    q, s = fdk.fused_decode_front(x, *front)
    qp, sp = fdk.fused_decode_front_plain(x, *front)
    torch.cuda.synchronize()
    assert fdk.fused_decode_front.launches == n0 + 1
    assert q.shape == qp.shape == (b, 56, 30, 256) and q.dtype == torch.int8
    assert s.shape == (b,)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
    diff = (q.int() - qp.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01
    # every reduction runs in a fixed order: a rerun is bit-identical
    q2, s2 = fdk.fused_decode_front(x, *front)
    assert torch.equal(q2, q) and torch.equal(s2, s)


@pytest.mark.parametrize("b", [1, 7, 64])
def test_fused_decode_kernel_matches_plain(teacher_expert1, b):
    """Kernel H within the int8 bound of the CPU tests, and with
    ``apply_expm1`` equal to ``expm1`` of its output."""
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    p, front, tail = teacher_expert1
    x = _dense1(p, b)
    n0 = fdk.fused_decode.launches
    out = fdk.fused_decode(x, *front, *tail)
    ref = fdk.fused_decode_plain(x, *front, *tail)
    counts = fdk.fused_decode(x, *front, *tail, apply_expm1=True)
    torch.cuda.synchronize()
    assert fdk.fused_decode.launches == n0 + 2
    assert out.shape == ref.shape == (b, 56, 30) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() < 0.05 * ref.abs().max().item() + 0.05
    torch.testing.assert_close(counts, torch.expm1(out), rtol=1e-5, atol=1e-5)
    assert torch.equal(fdk.fused_decode(x, *front, *tail), out)


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("conv", [0, 1, 2])
def test_fused_conv_int8_kernel_equals_plain(cuda, conv, b):
    """Each conv of G and H on the int8 tensor cores equals its plain version
    bit for bit: the int32 sums are exact in any order, and the epilogue
    rounds as the plain version does. Full-range int8 operands."""
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    xq, kq, sx, sk, bias = (t.to(cuda) for t in conv_inputs(conv, b, 100 * conv + b))
    args = (xq, sx, dk.pack_k_major(kq), sk, bias)
    n0 = fdk.fused_conv_int8.launches
    out = fdk.fused_conv_int8(conv, *args)
    ref = fdk.fused_conv_int8_plain(conv, *args)
    torch.cuda.synchronize()
    assert fdk.fused_conv_int8.launches == n0 + 1
    assert out.shape == ref.shape == (b, *fdk.CONVS[conv][1]) and out.dtype == torch.float32
    assert torch.equal(out, ref)
