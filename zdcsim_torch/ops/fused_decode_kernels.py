"""The fused int8 post-MLP decode of the ``fused_front`` and ``fused``
paths, with its plain versions (counterpart of
``zdcsim/ops/pallas_decode_fused.py``).

- :func:`fused_decode_front` replaces Pallas kernel G: from the Dense_1
  output, LayerNorm -> leaky -> per-sample int8 -> Conv_0's four parity
  phases (int32 sums, f32 epilogue, never rounded to bf16) -> GroupNorm_0
  (one pass over the whole 35x19 grid) -> leaky -> ONE per-sample int8 scale
  -> nearest resize to 56x30: ``(q int8 [B, 56, 30, 256], s f32 [B])``.
- :func:`fused_decode` replaces Pallas kernel H: the front, then Conv_1 (a
  plain 4x4 pad-1 int8 conv on the resized grid, per-cout weights) ->
  GroupNorm_1 -> leaky -> per-sample int8 -> Conv_2 (3x3 pad-1 int8) ->
  GroupNorm_2 -> leaky (f32) -> Conv_3 (2x2 pad-1, f32) -> ReLU [-> expm1]:
  ``f32 [B, 56, 30]``.

- :func:`fused_conv_int8` runs one of the three int8 convs (Conv_0's
  phases, Conv_1, Conv_2) as H launches it, so that each can be held bit
  for bit against its plain version on the card; nothing on the serving
  path calls it.

Both are full width only: C0..C3 = 512/256/128/64 are fixed, as in JAX.
Every int8 activation scale is per sample. The GroupNorms take the IEEE
``1 / sqrt`` where JAX takes ``lax.rsqrt``, as kernels A and C do. The convs
run on the int8 tensor cores, which read each weight as ``[Cout, taps x
Cin]`` int8, contiguous in K (:func:`dk.pack_k_major`); :func:`front_weights`
and :func:`tail_weights` pack once per expert, and the plain versions read
the logical layout back through :func:`dk.unpack_k_major`.

Each wrapper launches its CUDA entry point (``zdcsim_torch/csrc/
fused_decode.cu``: 3 device launches for G, 7 for H, 1 for a conv) for CUDA
tensors and runs the plain PyTorch version for CPU tensors; it never falls
back from one to the other. ``<wrapper>.launches`` counts the wrapper's
calls that launched the kernels (plain runs and CPU calls do not count).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from zdcsim_torch.ops import _build
from zdcsim_torch.ops import decode_kernels as dk

# Geometry of the full-width generator (pallas_decode_fused.py:88-91).
H0, W0, C0 = 18, 10, 512  # MLP grid
H1, W1, C1 = 35, 19, 256  # Conv_0 output
HG, WG = 56, 30  # resized and final grid
C2, C3 = 128, 64
GROUPS = 32
_ROW_MAP = np.floor((np.arange(HG) + 0.5) * H1 / HG).astype(np.int64)
_COL_MAP = np.floor((np.arange(WG) + 0.5) * W1 / WG).astype(np.int64)
# conv -> (source grid [h, w, cin], output grid [oh, ow, cout], logical kernel
# shape, sk shape): Conv_0's parity phases, Conv_1, Conv_2, as H runs them
CONVS = {
    0: ((H0, W0, C0), (H1, W1, C1), (25, C0, C1), (4, C1)),
    1: ((HG, WG, C1), (HG - 1, WG - 1, C2), (4, 4, C1, C2), (C2,)),
    2: ((HG - 1, WG - 1, C2), (HG - 1, WG - 1, C3), (3, 3, C2, C3), (C3,)),
}


def _quant_cout(k: torch.Tensor):
    """Per-output-channel symmetric int8 of a kernel, computed in float32:
    ``(q int8, s f32 [cout])`` (``pallas_decode_fused._quant_cout``)."""
    k = k.to(torch.float32)
    s = torch.clamp(k.abs().amax(dim=tuple(range(k.ndim - 1))) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(k / s), -127, 127).to(torch.int8)
    return q, s


def _conv_pad1_exact(xq: torch.Tensor, kq: torch.Tensor, out_hw) -> torch.Tensor:
    """Int32 sums of an NHWC int8 x HWIO int8 conv with one zero row/column
    before the grid, as one exact matmul per tap (``dk.exact_taps``), in
    float64; ``out_hw`` output positions."""
    ho, wo = out_hw
    kh, kw = kq.shape[:2]
    b, h, w, _ = xq.shape
    x, k64, acc_dtype = dk.exact_taps(xq, kq, kh * kw)
    xp = F.pad(x, (0, 0, 1, wo + kw - 2 - w, 1, ho + kh - 2 - h))
    acc = torch.zeros((b, ho, wo, kq.shape[-1]), dtype=acc_dtype, device=xq.device)
    for a in range(kh):
        for c in range(kw):
            acc += dk.tap_sum(xp[:, a:a + ho, c:c + wo], k64[a, c])
    return acc.to(torch.float64)


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what} (the fused decode is full width only)")


def _check_front(name, x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias):
    dev = x.device
    _require(x.ndim == 2 and x.shape[1] == H0 * W0 * C0
             and x.dtype in (torch.bfloat16, torch.float32), name,
             f"x must be [B, {H0 * W0 * C0}] bf16/f32, got {tuple(x.shape)} {x.dtype}")
    dk._require_f32(name, dev, ln_scale=ln_scale, ln_bias=ln_bias, sk0=sk0, b0=b0,
                    gn0_scale=gn0_scale, gn0_bias=gn0_bias)
    dk._check_packed(name, "kq0", kq0, 25, C0, dev, C1)
    _require(tuple(ln_scale.shape) == tuple(ln_bias.shape) == (H0 * W0 * C0,)
             and tuple(sk0.shape) == (4, C1)
             and tuple(b0.shape) == tuple(gn0_scale.shape) == tuple(gn0_bias.shape) == (C1,),
             name, f"ln_* must be [{H0 * W0 * C0}], sk0 [4, {C1}], b0 and gn0_* [{C1}]")


def _check_tail(name, dev, kq1, sk1, b1, gn1_scale, gn1_bias, kq2, sk2, b2, gn2_scale, gn2_bias,
                k3, b3):
    dk._require_f32(name, dev, sk1=sk1, b1=b1, gn1_scale=gn1_scale, gn1_bias=gn1_bias, sk2=sk2,
                    b2=b2, gn2_scale=gn2_scale, gn2_bias=gn2_bias, k3=k3, b3=b3)
    dk._check_packed(name, "kq1", kq1, 4 * 4, C1, dev, C2)
    dk._check_packed(name, "kq2", kq2, 3 * 3, C2, dev, C3)
    _require(all(tuple(t.shape) == (C2,) for t in (sk1, b1, gn1_scale, gn1_bias))
             and all(tuple(t.shape) == (C3,) for t in (sk2, b2, gn2_scale, gn2_bias))
             and tuple(k3.shape) == (2, 2, C3, 1) and tuple(b3.shape) == (1,), name,
             f"sk1, b1, gn1_* must be [{C2}], sk2, b2, gn2_* [{C3}], k3 [2, 2, {C3}, 1], b3 [1]")


def _gather_resize(q: torch.Tensor) -> torch.Tensor:
    rows = torch.from_numpy(_ROW_MAP).to(q.device)
    cols = torch.from_numpy(_COL_MAP).to(q.device)
    return q.index_select(1, rows).index_select(2, cols)


# ---------------------------------------------------------------------------
# G: the front half
# ---------------------------------------------------------------------------

def fused_decode_front_plain(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias):
    """Plain PyTorch version of :func:`fused_decode_front`: the plain
    versions of kernels A, B (with an f32 output) and C, then the int8
    gather of the nearest resize. Its arithmetic is the kernel's, op for op;
    the kernel sums the statistics in another order."""
    b = x.shape[0]
    xq, sx = dk.ln_leaky_rowquant_plain(x, ln_scale, ln_bias)
    y0 = fused_conv_int8_plain(0, xq.reshape(b, H0, W0, C0), sx, kq0, sk0, b0)
    q, s = dk.gn_leaky_rowquant_plain(y0, gn0_scale, gn0_bias, GROUPS)
    return _gather_resize(q), s.reshape(b)


def fused_decode_front(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias):
    """The front half of the fused decode.

    x: ``[B, 92160]`` bf16 or f32, the Dense_1 output before its LayerNorm;
    ln_scale, ln_bias: ``[92160]`` f32; kq0, sk0: ``dk._quant_phases`` of the
    Conv_0 kernel, kq0 packed by :func:`dk.pack_k_major` (``[256, 12800]``); b0,
    gn0_scale, gn0_bias: ``[256]`` f32. Returns ``(q int8 [B, 56, 30, 256],
    s f32 [B])``: the resized grid and its per-sample dequant scale.
    """
    name = "fused_decode_front"
    _check_front(name, x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)
    if x.device.type == "cpu":
        return fused_decode_front_plain(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)
    dk._require_cuda(x, name)
    b, dev = x.shape[0], x.device
    args = [t.contiguous() for t in (x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)]
    dk._require_aligned(name, 16, kq0=args[3])
    dk._require_aligned(name, 8, sk0=args[4], b0=args[5])
    q = torch.empty((b, HG, WG, C1), dtype=torch.int8, device=dev)
    s = torch.empty((b,), dtype=torch.float32, device=dev)
    ws_i8 = torch.empty((b * H0 * W0 * C0,), dtype=torch.int8, device=dev)
    ws_f32 = torch.empty((b * H1 * W1 * C1,), dtype=torch.float32, device=dev)
    ws_s = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.zdc_fused_decode_front(
            args[0].data_ptr(), int(x.dtype == torch.bfloat16), *(t.data_ptr() for t in args[1:]),
            ws_i8.data_ptr(), ws_f32.data_ptr(), ws_s.data_ptr(), q.data_ptr(), s.data_ptr(), b,
            dk._stream(x),
        )
    _build.check(status, name)
    fused_decode_front.launches += 1
    return q, s


fused_decode_front.launches = 0


# ---------------------------------------------------------------------------
# H: the whole post-MLP decode
# ---------------------------------------------------------------------------

def fused_decode_plain(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias,
                       kq1, sk1, b1, gn1_scale, gn1_bias, kq2, sk2, b2, gn2_scale, gn2_bias,
                       k3, b3, apply_expm1=False):
    """Plain PyTorch version of :func:`fused_decode`: the front's plain
    version, then each tail stage in the kernel's arithmetic (int8 convs as
    exact float64 sums, Conv_3 summed in float64 and rounded to f32 once, so
    that no TF32 or cuDNN choice enters it)."""
    q, s = fused_decode_front_plain(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)
    y1 = fused_conv_int8_plain(1, q, s, kq1, sk1, b1)
    q2, s2 = dk.gn_leaky_rowquant_plain(y1, gn1_scale, gn1_bias, GROUPS)
    y2 = fused_conv_int8_plain(2, q2, s2, kq2, sk2, b2)
    y2 = dk.gn_leaky_plain(y2, gn2_scale, gn2_bias, GROUPS).to(torch.float64)
    yp = F.pad(y2, (0, 0, 1, 1, 1, 1))
    k64 = k3.to(torch.float64)
    acc = sum(yp[:, a:a + HG, c:c + WG] @ k64[a, c] for a in range(2) for c in range(2))
    out = torch.relu(acc[..., 0].to(torch.float32) + b3)
    return torch.expm1(out) if apply_expm1 else out


def fused_decode(x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias,
                 kq1, sk1, b1, gn1_scale, gn1_bias, kq2, sk2, b2, gn2_scale, gn2_bias,
                 k3, b3, apply_expm1=False):
    """The whole post-MLP decode.

    The front's arguments as for :func:`fused_decode_front`; kq1, sk1:
    :func:`_quant_cout` of Conv_1 ``[4, 4, 256, 128]``; kq2, sk2: of Conv_2
    ``[3, 3, 128, 64]``; kq1 and kq2 packed by :func:`dk.pack_k_major`
    (``[128, 4096]``, ``[64, 1152]``); b1, gn1_*: ``[128]`` f32; b2, gn2_*:
    ``[64]`` f32; k3: Conv_3 ``[2, 2, 64, 1]`` f32; b3: ``[1]`` f32. Returns
    ``f32 [B, 56, 30]``: ``relu(conv3(...))`` (log-space pixel intensities), or its
    ``expm1`` (photon counts) with ``apply_expm1``.
    """
    name = "fused_decode"
    _check_front(name, x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)
    tail = (kq1, sk1, b1, gn1_scale, gn1_bias, kq2, sk2, b2, gn2_scale, gn2_bias, k3, b3)
    _check_tail(name, x.device, *tail)
    front = (x, ln_scale, ln_bias, kq0, sk0, b0, gn0_scale, gn0_bias)
    if x.device.type == "cpu":
        return fused_decode_plain(*front, *tail, apply_expm1=apply_expm1)
    dk._require_cuda(x, name)
    b, dev = x.shape[0], x.device
    args = [t.contiguous() for t in front + tail]
    dk._require_aligned(name, 16, kq0=args[3], kq1=args[8], kq2=args[13])
    dk._require_aligned(name, 8, sk0=args[4], b0=args[5], sk1=args[9], b1=args[10], sk2=args[14],
                     b2=args[15])
    out = torch.empty((b, HG, WG), dtype=torch.float32, device=dev)
    ws_i8 = torch.empty((b * HG * WG * C1,), dtype=torch.int8, device=dev)
    ws_f32 = torch.empty((b * (HG - 1) * (WG - 1) * C2,), dtype=torch.float32, device=dev)
    ws_s = torch.empty((3 * b,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.zdc_fused_decode(
            args[0].data_ptr(), int(x.dtype == torch.bfloat16), *(t.data_ptr() for t in args[1:]),
            ws_i8.data_ptr(), ws_f32.data_ptr(), ws_s.data_ptr(), out.data_ptr(),
            int(apply_expm1), b, dk._stream(x),
        )
    _build.check(status, name)
    fused_decode.launches += 1
    return out


fused_decode.launches = 0


# ---------------------------------------------------------------------------
# One conv stage of H, for tests
# ---------------------------------------------------------------------------

def fused_conv_int8_plain(conv, xq, sx, kp, sk, bias):
    """Plain PyTorch version of :func:`fused_conv_int8`: the int8 sums as
    exact float64 matmuls (:func:`dk.up2_conv4_int8_plain` for Conv_0's
    phases, :func:`_conv_pad1_exact` for Conv_1 and Conv_2) over the
    logical weights, then the kernel's f32 epilogue ``(f32(acc) * sk) * sx +
    bias``."""
    _, (oh, ow, _), logical, _ = CONVS[conv]
    if conv == 0:
        return dk.up2_conv4_int8_plain(xq, sx, kp, sk, bias, out_dtype=torch.float32)
    acc = _conv_pad1_exact(xq, dk.unpack_k_major(kp, logical), (oh, ow)).to(torch.float32)
    return acc * sk * sx.reshape(-1, 1, 1, 1) + bias


def fused_conv_int8(conv, xq, sx, kp, sk, bias):
    """One int8 conv of the fused decode as H launches it.

    conv 0: Conv_0's four parity phases, xq ``[B, 18, 10, 512]`` -> ``[B, 35,
    19, 256]``, kp, sk ``[4, 256]`` as in :func:`front_weights`; conv 1:
    Conv_1, ``[B, 56, 30, 256]`` -> ``[B, 55, 29, 128]``; conv 2: Conv_2,
    ``[B, 55, 29, 128]`` -> ``[B, 55, 29, 64]``, kp, sk as in
    :func:`tail_weights`. xq int8, sx ``[B]`` f32 per-sample scales, bias
    ``[Cout]`` f32. Returns the f32 output ``(f32(acc) * sk) * sx + bias``.
    """
    name = "fused_conv_int8"
    if conv not in CONVS:
        raise ValueError(f"{name}: conv must be one of {sorted(CONVS)}, got {conv!r}")
    src, (oh, ow, cout), logical, sk_shape = CONVS[conv]
    _require(xq.dtype == torch.int8 and xq.ndim == 4 and tuple(xq.shape[1:]) == src, name,
             f"xq must be [B, {', '.join(map(str, src))}] int8, got {tuple(xq.shape)} {xq.dtype}")
    b, dev = xq.shape[0], xq.device
    dk._check_packed(name, "kp", kp, math.prod(logical[:-2]), logical[-2], dev, cout)
    dk._require_f32(name, dev, sx=sx, sk=sk, bias=bias)
    _require(sx.numel() == b and tuple(sk.shape) == sk_shape and tuple(bias.shape) == (cout,),
             name, f"sx must have B values, sk be {list(sk_shape)}, bias [{cout}]")
    if dev.type == "cpu":
        return fused_conv_int8_plain(conv, xq, sx, kp, sk, bias)
    dk._require_cuda(xq, name)
    args = [t.contiguous() for t in (xq, sx, kp, sk, bias)]
    dk._require_aligned(name, 16, xq=args[0], kp=args[2])
    dk._require_aligned(name, 8, sk=args[3], bias=args[4])
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.zdc_fused_conv_int8(conv, *(t.data_ptr() for t in args), out.data_ptr(), b,
                                         dk._stream(xq))
    _build.check(status, name)
    fused_conv_int8.launches += 1
    return out


fused_conv_int8.launches = 0


# ---------------------------------------------------------------------------
# One expert's Flax-layout tree -> the kernels' weights
# ---------------------------------------------------------------------------

def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _gn(p, name):
    gn = p[name]["GroupNorm_0"]
    return _f32(gn["scale"]), _f32(gn["bias"])


_FULL_WIDTH = {"Conv_0": (4, 4, C0, C1), "Conv_1": (4, 4, C1, C2), "Conv_2": (3, 3, C2, C3),
               "Conv_3": (2, 2, C3, 1)}


def front_weights(p) -> tuple:
    """The front's weight arguments (after ``x``) from one expert's tree,
    quantized and packed once: the LN1 and GN0 parameters and Conv_0's bias
    in f32, and Conv_0's parity-phase int8 weights, K-major. Raises
    ``ValueError`` unless the tree has the full width."""
    for key, shape in _FULL_WIDTH.items():
        got = tuple(p[key]["kernel"].shape)
        _require(got == shape, "fused decode weights",
                 f"{key} kernel must be {list(shape)}, got {list(got)}")
    ln = p["MLPBlock_1"]["LayerNorm_0"]
    kq0, sk0 = dk._quant_phases(p["Conv_0"]["kernel"])
    return (_f32(ln["scale"]), _f32(ln["bias"]), dk.pack_k_major(kq0), sk0,
            _f32(p["Conv_0"]["bias"]), *_gn(p, "GroupNorm2d_0"))


def tail_weights(p) -> tuple:
    """H's tail weight arguments from one expert's tree: Conv_1 and Conv_2
    per-cout int8, K-major, the GN1/GN2 parameters, Conv_3 in f32."""
    kq1, sk1 = _quant_cout(p["Conv_1"]["kernel"])
    kq2, sk2 = _quant_cout(p["Conv_2"]["kernel"])
    kq1, kq2 = dk.pack_k_major(kq1), dk.pack_k_major(kq2)
    return (kq1, sk1, _f32(p["Conv_1"]["bias"]), *_gn(p, "GroupNorm2d_1"),
            kq2, sk2, _f32(p["Conv_2"]["bias"]), *_gn(p, "GroupNorm2d_2"),
            _f32(p["Conv_3"]["kernel"]), _f32(p["Conv_3"]["bias"]))


def fused_decode_front_from_params(p, x):
    """:func:`fused_decode_front` over one expert's tree of tensors."""
    return fused_decode_front(x, *front_weights(p))


def fused_decode_from_params(p, x, apply_expm1=False):
    """:func:`fused_decode` over one expert's tree of tensors (the tree
    ``fast_generator_apply`` consumes); ``x`` is the Dense_1 output."""
    return fused_decode(x, *front_weights(p), *tail_weights(p), apply_expm1=apply_expm1)
