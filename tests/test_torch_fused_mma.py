"""The K-major weight packing and the K order of the fused decode's int8
tensor-core convs (``zdcsim_torch/csrc/fused_decode.cu``, ``conv_mma_kernel``),
on the CPU.

The kernel sums, for each output position, the K = taps x Cin products of
one implicit GEMM per phase: K in tap-major order, each tap's slab of Cin
bytes one shifted NHWC source pixel (zero off the grid) against the packed
weights ``[Cout, taps x Cin]``, phase p's taps starting at slab ``tap0[p]``.
``_plans`` mirrors the kernel's ``conv0_plan`` and ``pad1_plan``; a float64
GEMM in that order over the packed weights must equal the plain versions'
sums bit for bit. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zdcsim_torch.convert import from_state_dict, tree_to_torch
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.ops import decode_kernels as dk
from zdcsim_torch.ops import fused_decode_kernels as fdk


def _plans(conv):
    """The kernel's ConvPhase list for ``conv`` (fused_decode.cu conv0_plan,
    pad1_plan): output positions mh x mw on the source grid, kr x kc taps
    reading offset (dr0 + a, dc0 + t), the first tap's slab tap0, and the
    output map (i * sr + pr, j * sc + pc)."""
    if conv == 0:
        return [dict(mh=18, mw=10, kr=2 if pr else 3, kc=2 if pc else 3, dr0=-(pr == 0),
                     dc0=-(pc == 0), tap0=(0, 9, 15, 21)[2 * pr + pc], sr=2, pr=pr, sc=2, pc=pc)
                for pr in (0, 1) for pc in (0, 1)]
    k = 4 if conv == 1 else 3
    return [dict(mh=55, mw=29, kr=k, kc=k, dr0=-1, dc0=-1, tap0=0, sr=1, pr=0, sc=1, pc=0)]


def _kernel_sums(xq, kp, ph):
    """The int8 sums of one phase as the kernel forms them: A [M, K] with K
    tap-major (tap (a, t), then Cin), B the phase's slab of the packed
    weights, summed as one float64 GEMM (exact: integers below 2**53).
    Returns ``[B, mh, mw, Cout]`` float64."""
    b, h, w, cin = xq.shape
    pad = 4  # more than any tap's reach past the grid
    xp = F.pad(xq.to(torch.float64), (0, 0, pad, pad, pad, pad))
    cols = []
    for a in range(ph["kr"]):
        for t in range(ph["kc"]):
            r0, c0 = pad + ph["dr0"] + a, pad + ph["dc0"] + t
            cols.append(xp[:, r0:r0 + ph["mh"], c0:c0 + ph["mw"]].reshape(-1, cin))
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


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_pack_k_major_is_tap_major_and_unpacks(conv):
    _, _, logical, _ = fdk.CONVS[conv]
    _, kq, _, _, _ = conv_inputs(conv, 1, conv)
    kp = fdk.pack_k_major(kq)
    cin, cout = logical[-2:]
    taps = int(np.prod(logical[:-2]))
    assert kp.shape == (cout, taps * cin) and kp.dtype == torch.int8 and kp.is_contiguous()
    flat = kq.reshape(taps, cin, cout)
    rng = np.random.default_rng(conv)
    for tap, c, n in zip(rng.integers(0, taps, 50), rng.integers(0, cin, 50),
                         rng.integers(0, cout, 50)):
        assert kp[n, tap * cin + c] == flat[tap, c, n]
    assert torch.equal(fdk.unpack_k_major(kp, logical), kq)


@pytest.mark.parametrize("conv,phase", [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (2, 0)])
def test_kernel_k_order_equals_the_plain_sums(conv, phase):
    """Conv_1 and Conv_2: equal to ``_conv_pad1_exact``; each Conv_0 phase:
    equal to ``up2_conv4_int8_plain``'s sums (sx = sk = 1, bias = 0) on that
    phase's output pixels, the odd phases' last row/column dropped. Through
    the f32 epilogue ``(f32(acc) * sk) * sx + bias`` they are
    ``fused_conv_int8_plain``'s output on those pixels."""
    xq, kq, sx, sk, bias = conv_inputs(conv, 2, 10 + conv)
    kp = fdk.pack_k_major(kq)
    plans = _plans(conv)
    # the slabs tile K in phase order, and K covers every tap once
    assert [ph["tap0"] for ph in plans] == list(
        np.cumsum([0] + [ph["kr"] * ph["kc"] for ph in plans])[:-1])
    assert sum(ph["kr"] * ph["kc"] for ph in plans) * xq.shape[-1] == kp.shape[1]
    ph = plans[phase]
    sums = _kernel_sums(xq, kp, ph)
    (oh, ow, cout), logical = fdk.CONVS[conv][1], fdk.CONVS[conv][2]
    rows = torch.arange(ph["mh"]) * ph["sr"] + ph["pr"]
    cols = torch.arange(ph["mw"]) * ph["sc"] + ph["pc"]
    rk, ck = rows < oh, cols < ow
    got = sums[:, rk][:, :, ck]
    if conv:
        assert torch.equal(sums, fdk._conv_pad1_exact(xq, kq, (oh, ow)))
    else:
        ref = dk.up2_conv4_int8_plain(xq, torch.ones(2), fdk.unpack_k_major(kp, logical),
                                      torch.ones((4, cout)), torch.zeros(cout), torch.float32)
        assert got.shape[1:3] == ((oh + 1 - ph["pr"]) // 2, (ow + 1 - ph["pc"]) // 2)
        assert torch.equal(got.to(torch.float32), ref[:, rows[rk]][:, :, cols[ck]])
    out = fdk.fused_conv_int8_plain(conv, xq, sx, kp, sk, bias)
    val = got.to(torch.float32) * (sk[phase] if conv == 0 else sk) * sx.reshape(-1, 1, 1, 1) + bias
    assert torch.equal(out[:, rows[rk]][:, :, cols[ck]], val)


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_fused_conv_int8_on_cpu_runs_the_plain_version(conv):
    """A CPU tensor runs the plain version and counts no launch."""
    xq, kq, sx, sk, bias = conv_inputs(conv, 2, 20 + conv)
    kp = fdk.pack_k_major(kq)
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
    logical0 = fdk.unpack_k_major(front[2], (25, 512, 256)).contiguous()
    with pytest.raises(ValueError, match=r"kq0 must be \[256, 12800\]"):
        fdk.fused_decode_front(x, *front[:2], logical0, *front[3:])
    logical1 = fdk.unpack_k_major(tail[0], (4, 4, 256, 128)).contiguous()
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
