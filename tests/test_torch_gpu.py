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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f", [(3, 1000), (16, 92160)])
def test_ln_leaky_rowquant_kernel_matches_plain(cuda, dtype, b, f):
    rng = np.random.default_rng(b + f)
    y = torch.as_tensor(rng.standard_normal((b, f), dtype=np.float32) * 3).to(cuda, dtype)
    scale = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.5 + 1).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(f, dtype=np.float32) * 0.2).to(cuda)
    n0 = dk.ln_leaky_rowquant.launches
    q, s = dk.ln_leaky_rowquant(y, scale, bias)
    qp, sp = dk.ln_leaky_rowquant_plain(y, scale, bias)
    torch.cuda.synchronize()
    assert dk.ln_leaky_rowquant.launches == n0 + 1
    assert q.shape == (b, f) and q.dtype == torch.int8 and s.shape == (b, 1)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=0)
    # bounds of tests/test_pallas_decode.py:36-44: the sums run in another order
    diff = (q.int() - qp.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01


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


@pytest.mark.parametrize("dtype,b,h,w,c", [(torch.float32, 3, 5, 3, 64),
                                           (torch.bfloat16, 16, 35, 19, 256),
                                           (torch.bfloat16, 5, 35, 19, 32)])
def test_gn_leaky_rowquant_kernel_matches_plain(cuda, dtype, b, h, w, c):
    rng = np.random.default_rng(b + c)
    x = torch.as_tensor(rng.standard_normal((b, h, w, c), dtype=np.float32) * 2 + 0.5).to(cuda, dtype)
    scale = torch.as_tensor(np.abs(rng.standard_normal(c, dtype=np.float32)) + 0.5).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(c, dtype=np.float32) * 0.3).to(cuda)
    n0 = dk.gn_leaky_rowquant.launches
    q, s = dk.gn_leaky_rowquant(x, scale, bias)
    qp, sp = dk.gn_leaky_rowquant_plain(x, scale, bias)
    torch.cuda.synchronize()
    assert dk.gn_leaky_rowquant.launches == n0 + 1
    assert q.shape == (b, h, w, c) and q.dtype == torch.int8 and s.shape == (b, 1)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
    # the statistics are summed in another order: at most round-boundary flips
    diff = (q.int() - qp.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() < 0.01


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
    """Kernel E; 7x5 has odd sides and 35 pixels (the scalar-load path), 37
    showers are not a multiple of a block's 8 warps."""
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(b + h + w)
    x = torch.as_tensor(rng.random((b, h, w), dtype=np.float32) * 3).to(cuda, dtype)
    n0 = ek.expm1_channel_sums.launches
    out = ek.expm1_channel_sums(x)
    ref = ek.expm1_channel_sums_plain(x)
    torch.cuda.synchronize()
    assert ek.expm1_channel_sums.launches == n0 + 1
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
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(5)
    imgs = torch.as_tensor(rng.random((3, 6, 56, 30), dtype=np.float32)).to(cuda)
    idx = torch.tensor([0, -1, 2, 3, 1, 1 << 40], device=cuda)
    out = ek.routed_expm1_channel_sums(imgs, idx)
    ref = ek.routed_expm1_channel_sums_plain(imgs, idx)
    torch.cuda.synchronize()
    bad = torch.tensor([False, True, False, True, False, True], device=cuda)
    assert torch.isnan(out[bad]).all() and torch.isnan(ref[bad]).all()
    assert torch.isfinite(out[~bad]).all()
    torch.testing.assert_close(out[~bad], ref[~bad], rtol=1e-5, atol=0)


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
