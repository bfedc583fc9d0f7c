"""Fast proton generator forward, float and int8 (counterpart of
``zdcsim/models/proton_fast.py``).

:func:`fast_generator_apply` runs ``Generator``'s forward from the Flax
layout parameter tree of one expert (tensors; see ``zdcsim_torch.convert``)
with Conv_0 as four parity-phase convs on the 18x10 grid instead of a 4x4
conv on the upsampled 36x20 grid. Activations are NHWC and kernels HWIO at
every function boundary, as in JAX.

int8 (``int8=True``): symmetric int8 with ``round`` half to even and a clip
at +-127; weights per output channel, activations per tensor (the XLA
backend) or per sample (the kernels of the ``pallas_ab`` and ``pallas``
backends). The XLA backend's per-tensor scales are the dynamic max of each
call, or static calibrated scales (``act_scales``; ``amax_out`` captures the
maxima that a calibration scales from).

- ``int8_backend="xla"``: every int8 stage is plain PyTorch.
- ``int8_backend="pallas_ab"``: the MLP's LayerNorm + LeakyReLU + quant and
  Conv_0 run on the CUDA kernels that replace Pallas kernels A and B
  (``zdcsim_torch.ops.decode_kernels``); Conv_1 and Conv_2 stay plain.
- ``int8_backend="pallas"``: as ``pallas_ab``, and GroupNorm2d_0 + LeakyReLU
  + quant and the row-resize Conv_1 run on the kernels that replace Pallas
  kernels C and D; Conv_2 stays plain.
- ``int8_backend="fused_front"``: everything from the MLP's LayerNorm to the
  int8 grid resized to 56x30 runs on the kernel that replaces Pallas kernel
  G (``zdcsim_torch.ops.fused_decode_kernels``); Conv_1 is the plain int8
  conv on that grid, then the ``xla`` tail.
- ``int8_backend="fused"``: the whole decode after the MLP runs on the
  kernel that replaces Pallas kernel H.

The fused backends are full width only (as in JAX); their int8 activation
scales are per sample.

The plain int8 convs (:func:`_conv_i8`) sum int8 products in int32, as the
JAX ``_conv_i8`` does (``preferred_element_type=int32``): one
``torch._int_mm`` per kernel tap, exact on both devices.

JAX's four serving switches are module attributes of the same names and
defaults (:data:`DEQUANT_DTYPE`, :data:`INT8_CONV2`, :data:`INT8_CONV0_IMPL`,
:data:`INT8_CONV1_IMPL`). :func:`quantize_weights` reads them, and the
weights it returns record the form they hold, which the decode follows: a
decode never mixes forms, and an engine built before a switch flips keeps
its form.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from zdcsim_torch.models.layers import (
    group_norm_groups, leaky_relu, nearest_index, nearest_index_on, resize_nearest,
    upsample_nearest,
)
from zdcsim_torch.ops import decode_kernels as dk
from zdcsim_torch.ops import fused_decode_kernels as fdk

QWeights = Tuple[torch.Tensor, torch.Tensor]


def _conv(x: torch.Tensor, k: torch.Tensor, pad, stride=(1, 1)) -> torch.Tensor:
    """NHWC x HWIO cross-correlation, ``pad = ((top, bottom), (left, right))``."""
    xt = F.pad(x.permute(0, 3, 1, 2), (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    return F.conv2d(xt, k.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def _conv_i8(xq: torch.Tensor, kq: torch.Tensor, pad, stride=(1, 1)) -> torch.Tensor:
    """NHWC int8 x HWIO int8 cross-correlation with int32 sums, as the JAX
    ``_conv_i8``: for each of the kh x kw taps, ``torch._int_mm`` of the
    shifted window ``[B*Ho*Wo, Cin]`` against the tap's ``[Cin, Cout]``
    weights, summed in int32. Bit-equal to a direct integer sum.

    ``torch._int_mm`` needs more than 16 rows and ``Cin``, ``Cout``
    multiples of 8 (every conv of the decode meets this); other shapes
    raise, with no float fallback.
    """
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise ValueError(f"_conv_i8: int8 operands expected, got {xq.dtype} and {kq.dtype}")
    b, h, w, cin = xq.shape
    kh, kw, kcin, cout = kq.shape
    (pt, pb), (pl, pr) = pad
    ho = (h + pt + pb - kh) // stride[0] + 1
    wo = (w + pl + pr - kw) // stride[1] + 1
    m = b * ho * wo
    if kcin != cin or m <= 16 or cin % 8 or cout % 8:
        raise ValueError(
            f"_conv_i8: torch._int_mm needs > 16 rows and Cin, Cout multiples of 8; "
            f"got {m} rows, Cin {cin} (kernel {kcin}), Cout {cout}"
        )
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    # column-major [Cin, Cout] operands, the layout cuBLASLt's int8 GEMM takes
    kt = kq.permute(0, 1, 3, 2).contiguous()
    acc = None
    for a in range(kh):
        for c in range(kw):
            win = xp[:, a:a + stride[0] * (ho - 1) + 1:stride[0],
                     c:c + stride[1] * (wo - 1) + 1:stride[1]]
            part = torch._int_mm(win.reshape(m, cin), kt[a, c].t())
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(b, ho, wo, cout)


# Pads that give each phase conv the full HxW source grid; the odd phases'
# extra row/column is trimmed by the interleave.
_FULL_GRID_PADS = {
    "ee": ((1, 1), (1, 1)), "eo": ((1, 1), (0, 1)),
    "oe": ((0, 1), (1, 1)), "oo": ((0, 1), (0, 1)),
}


def _phase_convs(x, ks, conv):
    """The four parity-phase convs on the source grid, interleaved."""
    return dk.interleave_phases(
        torch.stack([conv(x, ks[name], _FULL_GRID_PADS[name]) for name in dk._PHASES])
    )


def _conv_vjp(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor):
    """``(d x, d kernel)`` of the pad-1 :func:`_conv` of NHWC ``x`` and HWIO
    ``kernel`` against the cotangent ``g``, without running its forward
    (autograd of the naive form would)."""
    xt, w, gt = x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xt.shape, w, gt, padding=1)
    dw = torch.nn.grad.conv2d_weight(xt, w.shape, gt, padding=1)
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


class _FusedUp2Conv4(torch.autograd.Function):
    """The parity-phase forward; JAX's custom backward
    (``zdcsim/models/proton_fast.py:98-112``): the VJP of the naive
    upsample + conv (the upsample's as a sum over each 2x2 block), the
    bias's gradient the sum of ``g``."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _phase_convs(x, dk._phase_kernels(kernel), _conv) + bias

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        b, h, w, c = x.shape
        dxu, dkernel = _conv_vjp(upsample_nearest(x), kernel, g)
        return dxu.reshape(b, h, 2, w, 2, c).sum(dim=(2, 4)), dkernel, g.sum(dim=(0, 1, 2))


def fused_upsample2_conv4(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv4x4(pad1, nearest_up2(x))`` without materialising the upsample:
    x ``[B, H, W, Cin]``, kernel HWIO ``[4, 4, Cin, Cout]`` ->
    ``[B, 2H-1, 2W-1, Cout]``. Its gradient is the naive form's."""
    return _FusedUp2Conv4.apply(x, kernel, bias)


# Per-output-channel symmetric int8 of a kernel: ``(q, s [cout])``.
_quant_per_cout = fdk._quant_cout


def _quant_act(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Per-tensor symmetric int8 of activations: ``(q, s)``.

    ``scale=None``: the dynamic scale of one max over the tensor.
    ``scale``: a static calibrated f32 scalar; values beyond its range clip at
    +-127. Both divide by the f32 scale (``x / s``, as JAX), so a static scale
    equal to the dynamic one gives the same ``q`` bit for bit.
    """
    x = x.to(torch.float32)
    if scale is None:
        s = torch.clamp(x.abs().amax() / 127.0, min=1e-12)
    else:
        s = scale.to(torch.float32)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


# JAX's serving switches (zdcsim/models/proton_fast.py:272-286), each set
# there by a TPU measurement; the port runs their defaults, and keeps the
# other settings for measurement on the card.
# The int8 convs' dequantise dtype (None: float32); the fused backend's
# kernel dequantises in float32 whatever it holds.
DEQUANT_DTYPE: Optional[torch.dtype] = None
# Conv_2 on int8 (False: the float conv in the compute dtype); every int8
# backend but the fused one.
INT8_CONV2 = True
# The XLA backend's Conv_0: "phase" (or "folded") the four parity-phase
# convs of the source grid; "naive" the int8 upsample, then one 4x4 conv.
INT8_CONV0_IMPL = "phase"
# The XLA and pallas_ab backends' Conv_1: "naive" the int8 nearest resize,
# then one 4x4 conv; "phase" (or "folded") the eight row-phase convs.
INT8_CONV1_IMPL = "naive"
_IMPLS = ("phase", "folded", "naive")


def _dequant(y, sk, sx, bias, dtype, dq=torch.float32):
    """``dq(y) * dq(sk * sx) + dq(bias)`` in ``dq``, cast to ``dtype``."""
    return (y.to(dq) * (sk * sx).to(dq) + bias.to(dq)).to(dtype)


def conv3x3_int8(x: torch.Tensor, q: QWeights, bias: torch.Tensor,
                 act_scale: Optional[torch.Tensor] = None, dq=torch.float32) -> torch.Tensor:
    """Pad-1 3x3 conv on int8 data: ``q = _quant_per_cout(kernel)``;
    ``act_scale`` as :func:`_quant_act`'s ``scale``; dequantised in ``dq``."""
    xq, sx = _quant_act(x, act_scale)
    kq, sk = q
    return _dequant(_conv_i8(xq, kq, ((1, 1), (1, 1))), sk, sx, bias, x.dtype, dq)


def quant_conv0_phases(kernel: torch.Tensor) -> Dict[str, QWeights]:
    """The XLA int8 Conv_0 weights: merged in the kernel's own dtype, then each
    phase kernel quantized per output channel (as
    ``zdcsim.models.proton_fast.fused_upsample2_conv4_int8`` does)."""
    return {name: _quant_per_cout(k) for name, k in dk._phase_kernels(kernel).items()}


def fused_upsample2_conv4_int8(x: torch.Tensor, q: Dict[str, QWeights], bias: torch.Tensor,
                               act_scale: Optional[torch.Tensor] = None,
                               dq=torch.float32) -> torch.Tensor:
    """int8 :func:`fused_upsample2_conv4` with one per-tensor activation
    scale (dynamic, or ``act_scale``); ``q = quant_conv0_phases(kernel)``;
    dequantised and interleaved in ``dq``."""
    xq, sx = _quant_act(x, act_scale)

    def qconv(x_, k, pad):
        kq, sk = k
        return _conv_i8(x_, kq, pad).to(dq) * (sk * sx).to(dq)

    out = _phase_convs(xq, q, qconv)
    return (out + bias.to(dq)).to(x.dtype)


def upsample2_conv4_int8_naive(x: torch.Tensor, q: QWeights, bias: torch.Tensor,
                               act_scale: Optional[torch.Tensor] = None,
                               dq=torch.float32) -> torch.Tensor:
    """The naive int8 Conv_0 (``INT8_CONV0_IMPL = "naive"``): the nearest 2x
    upsample of the int8 activations, then one plain 4x4 pad-1 conv, ``[B,
    2H-1, 2W-1, Cout]``; ``q = _quant_per_cout(kernel)`` of the original
    kernel (the phase form quantises its merged phase kernels: another valid
    rounding)."""
    xq, sx = _quant_act(x, act_scale)
    xu = xq.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    kq, sk = q
    return _dequant(_conv_i8(xu, kq, ((1, 1), (1, 1))), sk, sx, bias, x.dtype, dq)


def resize_conv4_int8_naive(x: torch.Tensor, q: QWeights, bias: torch.Tensor,
                            n_resized_rows: int, n_cols: int,
                            act_scale: Optional[torch.Tensor] = None,
                            dq=torch.float32) -> torch.Tensor:
    """Nearest resize of the int8 activations, then one plain 4x4 pad-1 conv:
    ``q = _quant_per_cout(kernel)``; ``act_scale`` as :func:`_quant_act`'s."""
    xq, sx = _quant_act(x, act_scale)
    xr = resize_nearest(xq, (n_resized_rows, n_cols))
    kq, sk = q
    return _dequant(_conv_i8(xr, kq, ((1, 1), (1, 1))), sk, sx, bias, x.dtype, dq)


def _row_phase_plan(n_in: int, n_out: int, ksize: int, pad: int):
    """Phases of a nearest row-resize ``n_in -> n_out`` folded into a
    ``ksize``-tap row conv with ``pad`` (own copy of the JAX
    ``_row_phase_plan``, element for element).

    Output rows repeat with period ``q`` (``n_in / n_out = p / q`` reduced);
    within a phase the conv's taps hit a fixed set of distinct source rows.
    Returns ``(q, p, plans)`` with one ``(d0, groups, n_phase)`` per phase:
    ``groups[l] = (d, taps)`` merges kernel row taps ``taps`` onto source
    row offset ``d``, and the phase has ``n_phase`` output rows. For 35 -> 56,
    ksize 4, pad 1: q = 8 phases of period p = 5, 55 output rows.
    """
    g = math.gcd(n_in, n_out)
    p_num, q = n_in // g, n_out // g
    src = nearest_index(n_out, n_in)
    n_conv_out = n_out + 2 * pad - ksize + 1
    plans = []
    for phase in range(q):
        rel = []
        for a in range(ksize):
            r = phase - pad + a
            rel.append(src[r] if 0 <= r < n_out else src[0] - 1)
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


def _row_phase_kernels(kernel: torch.Tensor, h_in: int, n_resized_rows: int):
    """Each row phase's kernel, its row taps merged by group, in the
    kernel's dtype: ``[len(groups), 4, Cin, Cout]`` per phase."""
    plans = _row_phase_plan(h_in, n_resized_rows, 4, 1)[2]
    return [torch.stack([sum(kernel[a] for a in taps) for _, taps in groups])
            for _, groups, _ in plans]


def quant_conv1_row_phases(kernel: torch.Tensor, h_in: int = 35,
                           n_resized_rows: int = 56) -> list:
    """The row-phase int8 Conv_1 weights (``INT8_CONV1_IMPL = "phase"``):
    each phase's merged kernel quantized per output channel, as JAX's
    ``fused_row_resize_conv4_int8`` does inline."""
    return [_quant_per_cout(k) for k in _row_phase_kernels(kernel, h_in, n_resized_rows)]


def _row_phase_convs(x, ks, n_resized_rows, conv):
    """Shared body of the folded row-resize convs: per phase, run
    ``conv(rows, ks[phase], pad, stride)`` on the phase's rows (``ks`` the
    merged kernels of :func:`_row_phase_kernels`, or what ``conv`` takes for
    them), and interleave the phases into ``[B, n_resized_rows - 1, W,
    Cout]``."""
    b, h_in = x.shape[:2]
    q, p_num, plans = _row_phase_plan(h_in, n_resized_rows, 4, 1)
    max_n = max(n for _, _, n in plans)
    outs = []
    for (d0, groups, n_phase), k_p in zip(plans, ks):
        pad_t, start = max(-d0, 0), max(d0, 0)
        span = p_num * (n_phase - 1) + len(groups)
        pad_b = max(0, span - pad_t - (h_in - start))
        y = conv(x[:, start:], k_p, ((pad_t, pad_b), (1, 1)), (p_num, 1))[:, :n_phase]
        outs.append(F.pad(y, (0, 0, 0, 0, 0, max_n - n_phase)))
    out = torch.stack(outs, dim=2)  # [B, max_n, q, W, Cout]
    return out.reshape(b, max_n * q, *out.shape[3:])[:, : n_resized_rows - 1]


class _FusedRowResizeConv4(torch.autograd.Function):
    """The row-phase forward; JAX's custom backward
    (``zdcsim/models/proton_fast.py:205-222``): the VJP of the naive resize +
    conv, the bias's gradient the sum of ``g``."""

    @staticmethod
    def forward(ctx, x, kernel, bias, n_resized_rows, n_cols):
        ctx.save_for_backward(x, kernel)
        ctx.size = (n_resized_rows, n_cols)
        xc = x.index_select(2, nearest_index_on(n_cols, x.shape[2], x.device))
        ks = _row_phase_kernels(kernel, x.shape[1], n_resized_rows)
        return _row_phase_convs(xc, ks, n_resized_rows, _conv) + bias

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dxr, dkernel = _conv_vjp(resize_nearest(x, ctx.size), kernel, g)
        with torch.enable_grad():  # the resize's own backward: gathers (gather_nearest)
            xd = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(resize_nearest(xd, ctx.size), xd, dxr)
        return dx, dkernel, g.sum(dim=(0, 1, 2)), None, None


def fused_row_resize_conv4(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                           n_resized_rows: int, n_cols: int) -> torch.Tensor:
    """``conv4x4(pad1, resize_nearest(x, (n_resized_rows, n_cols)))`` with the
    row resize folded into per-phase strided convs (columns are gathered):
    ``[B, n_resized_rows - 1, n_cols - 1, Cout]``. Its gradient is the
    naive form's."""
    return _FusedRowResizeConv4.apply(x, kernel, bias, n_resized_rows, n_cols)


def fused_row_resize_conv4_int8(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                                n_resized_rows: int, n_cols: int,
                                act_scale: Optional[torch.Tensor] = None, q: Optional[list] = None,
                                dq=torch.float32) -> torch.Tensor:
    """int8 :func:`fused_row_resize_conv4` (the JAX XLA twin of kernel D):
    one per-tensor activation scale (dynamic, or ``act_scale``), each
    phase's merged kernel quantized per output channel (``q``, from
    :func:`quant_conv1_row_phases`, or here from ``kernel``), int32 sums,
    dequantised in ``dq``."""
    xc = x.index_select(2, torch.from_numpy(nearest_index(n_cols, x.shape[2])).to(x.device))
    xq, sx = _quant_act(xc, act_scale)
    if q is None:
        q = quant_conv1_row_phases(kernel, x.shape[1], n_resized_rows)

    def qconv(x_, k_p, pad, stride):
        kq, sk = k_p
        return _conv_i8(x_, kq, pad, stride).to(dq) * (sk * sx).to(dq)

    out = _row_phase_convs(xq, q, n_resized_rows, qconv)
    return (out + bias.to(dq)).to(x.dtype)


def _layer_norm(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _group_norm(x, p):
    g = group_norm_groups(x.shape[-1], 32)
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-6)
    return xg.reshape(b, h, w, c) * p["scale"] + p["bias"]


_INT8_BACKENDS = ("xla", "pallas_ab", "pallas", "fused_front", "fused")


def quantize_weights(p: Dict[str, Any], int8_backend: str = "xla") -> Dict[str, Any]:
    """One expert's int8 weights for :func:`fast_generator_apply`, computed
    once per weight set (JAX hoists the same work out of its loops). The
    kernels take their per-channel parameters in float32, cast here once,
    and their int8 conv weights packed K-major (``dk.pack_k_major``). The
    fused backends take full-width trees only and raise ``ValueError`` on
    any other.

    Reads the switches (:data:`DEQUANT_DTYPE`, :data:`INT8_CONV2`,
    :data:`INT8_CONV0_IMPL`, :data:`INT8_CONV1_IMPL`) and records the form
    the weights hold: ``"dq"`` the dequantise dtype, ``"conv0_impl"`` (the
    XLA backend) and ``"conv1_impl"`` (the XLA and ``pallas_ab`` backends)
    the conv forms, ``"conv2"`` ``None`` where Conv_2 runs in float."""
    if int8_backend not in _INT8_BACKENDS:
        raise ValueError(f"int8_backend must be one of {_INT8_BACKENDS}, got {int8_backend!r}")
    if int8_backend == "fused":
        return {"front": fdk.front_weights(p), "tail": fdk.tail_weights(p)}
    for name, impl in (("INT8_CONV0_IMPL", INT8_CONV0_IMPL), ("INT8_CONV1_IMPL", INT8_CONV1_IMPL)):
        if impl not in _IMPLS:
            raise ValueError(f"{name} must be one of {_IMPLS}, got {impl!r}")
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    q = {"dq": DEQUANT_DTYPE or torch.float32,
         "conv2": _quant_per_cout(p["Conv_2"]["kernel"]) if INT8_CONV2 else None}
    if int8_backend == "fused_front":
        q["front"] = fdk.front_weights(p)
    elif int8_backend == "xla":
        q["conv0_impl"] = "naive" if INT8_CONV0_IMPL == "naive" else "phase"
        q["conv0"] = (_quant_per_cout(p["Conv_0"]["kernel"]) if q["conv0_impl"] == "naive"
                      else quant_conv0_phases(p["Conv_0"]["kernel"]))
    else:
        ln = p["MLPBlock_1"]["LayerNorm_0"]
        q["ln1"] = (f32(ln["scale"]), f32(ln["bias"]))
        kq0, sk0 = dk._quant_phases(p["Conv_0"]["kernel"])
        q["conv0"] = (dk.pack_k_major(kq0), sk0)
        q["conv0_bias"] = f32(p["Conv_0"]["bias"])
    if int8_backend == "pallas":
        gn = p["GroupNorm2d_0"]["GroupNorm_0"]
        q["gn0"] = (f32(gn["scale"]), f32(gn["bias"]))
        k1 = p["Conv_1"]["kernel"]
        _, _, plans = _row_phase_plan(35, 56, 4, 1)
        kq1, sk1, offsets = dk._quant_row_phases(k1, plans)
        q["conv1"] = (dk.pack_k_major(kq1), sk1, offsets)
        q["conv1_bias"] = f32(p["Conv_1"]["bias"])
        q["col_map"] = torch.from_numpy(nearest_index(30, 19)).to(k1.device)
    elif int8_backend == "fused_front":  # the plain conv on the kernel's resized grid
        q["conv1"] = _quant_per_cout(p["Conv_1"]["kernel"])
    else:
        q["conv1_impl"] = "naive" if INT8_CONV1_IMPL == "naive" else "phase"
        q["conv1"] = (_quant_per_cout(p["Conv_1"]["kernel"]) if q["conv1_impl"] == "naive"
                      else quant_conv1_row_phases(p["Conv_1"]["kernel"]))
    return q


def mlp_apply(params: Dict[str, Any], noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """The generator's MLP up to the Dense_1 output, before its LayerNorm:
    ``[B, 18 * 10 * C0]``."""
    x = torch.cat([noise, cond], dim=1)
    bp0 = params["MLPBlock_0"]
    x = x @ bp0["Dense_0"]["kernel"] + bp0["Dense_0"]["bias"]
    x = leaky_relu(_layer_norm(x, bp0["LayerNorm_0"]))
    bp1 = params["MLPBlock_1"]
    return x @ bp1["Dense_0"]["kernel"] + bp1["Dense_0"]["bias"]


def _conv0_conv1(p, x, dtype, int8, int8_backend, qweights, scales, site, train):
    """LN1 -> Conv_0 -> GN0 -> resize + Conv_1 of the unfused backends:
    ``[B, 55, 29, 128]`` in ``dtype``. ``scales``, ``site`` and ``train`` as
    in :func:`decode_apply`."""
    use_ab = int8 and int8_backend in ("pallas_ab", "pallas")
    use_cd = int8 and int8_backend == "pallas"
    c0 = p["MLPBlock_1"]["Dense_0"]["kernel"].shape[1] // (18 * 10)
    if use_ab:
        xq, sx = dk.ln_leaky_rowquant(x, *qweights["ln1"])
        kp, sk = qweights["conv0"]
        x = dk.up2_conv4_int8(
            xq.reshape(-1, 18, 10, c0), sx, kp, sk, qweights["conv0_bias"], out_dtype=dtype,
        )
    else:
        x = leaky_relu(_layer_norm(x, p["MLPBlock_1"]["LayerNorm_0"]))
        x = site(x.reshape(-1, 18, 10, c0), "conv0")
        if int8:
            conv0 = (upsample2_conv4_int8_naive if qweights["conv0_impl"] == "naive"
                     else fused_upsample2_conv4_int8)
            x = conv0(x, qweights["conv0"], p["Conv_0"]["bias"], scales.get("conv0"),
                      qweights["dq"])
        else:
            x = fused_upsample2_conv4(x, p["Conv_0"]["kernel"], p["Conv_0"]["bias"])

    # resize 35x19 -> 56x30 + Conv_1 4x4 pad 1 -> 55x29
    if use_cd:
        # GN + leaky + per-sample int8 (kernel C), the int8 column gather,
        # then the row-phase conv with dequant and interleave (kernel D)
        xq, sx = dk.gn_leaky_rowquant(x, *qweights["gn0"],
                                      groups=group_norm_groups(x.shape[-1], 32))
        kp, sk, offsets = qweights["conv1"]
        return dk.row_resize_conv4_int8(
            xq.index_select(2, qweights["col_map"]), sx, kp, sk, offsets,
            qweights["conv1_bias"], 56, out_dtype=dtype,
        )[:, :, :29]
    x = site(leaky_relu(_group_norm(x, p["GroupNorm2d_0"]["GroupNorm_0"])), "conv1")
    if int8 and qweights["conv1_impl"] == "naive":
        return resize_conv4_int8_naive(x, qweights["conv1"], p["Conv_1"]["bias"], 56, 30,
                                       scales.get("conv1"), qweights["dq"])
    if int8:
        return fused_row_resize_conv4_int8(x, p["Conv_1"]["kernel"], p["Conv_1"]["bias"], 56,
                                           30, scales.get("conv1"), qweights["conv1"],
                                           qweights["dq"])
    if train:
        return fused_row_resize_conv4(x, p["Conv_1"]["kernel"], p["Conv_1"]["bias"], 56, 30)
    x = _conv(resize_nearest(x, (56, 30)), p["Conv_1"]["kernel"], ((1, 1), (1, 1)))
    return x + p["Conv_1"]["bias"]


def decode_apply(
    params: Dict[str, Any], x: torch.Tensor, dtype: torch.dtype, int8: bool = False,
    int8_backend: str = "xla", qweights: Optional[Dict[str, Any]] = None,
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    amax_out: Optional[Dict[str, torch.Tensor]] = None, train: bool = False,
) -> torch.Tensor:
    """The decode after the MLP, from the Dense_1 output ``x``
    (:func:`mlp_apply`): ``[B, 56, 30, 1]`` in ``dtype``. Arguments as for
    :func:`fast_generator_apply`."""
    p = params
    scales = act_scales or {}

    def site(t, name):
        # calibration capture: this quant site's input max-abs, in f32
        if amax_out is not None:
            amax_out[name] = t.to(torch.float32).abs().amax()
        return t

    if int8 and qweights is None:
        qweights = quantize_weights(p, int8_backend)
    if int8 and int8_backend == "fused":
        # the whole decode on kernel H, cast to the compute dtype as JAX does
        return fdk.fused_decode(x, *qweights["front"], *qweights["tail"])[..., None].to(dtype)
    if int8 and int8_backend == "fused_front":
        # kernel G, then the plain int8 Conv_1 on its resized grid, dequantized
        # as JAX's dq(y) * (dq(sk) * dq(s[b])) + dq(bias)
        q, s = fdk.fused_decode_front(x, *qweights["front"])
        kq, sk = qweights["conv1"]
        dq = qweights["dq"]
        x = _dequant(_conv_i8(q, kq, ((1, 1), (1, 1))), sk.to(dq), s.reshape(-1, 1, 1, 1).to(dq),
                     p["Conv_1"]["bias"], dtype, dq)
    else:
        x = _conv0_conv1(p, x, dtype, int8, int8_backend, qweights, scales, site, train)
    x = site(leaky_relu(_group_norm(x, p["GroupNorm2d_1"]["GroupNorm_0"])), "conv2")

    if int8 and qweights["conv2"] is not None:
        x = conv3x3_int8(x, qweights["conv2"], p["Conv_2"]["bias"], scales.get("conv2"),
                         qweights["dq"])
    else:
        x = _conv(x, p["Conv_2"]["kernel"], ((1, 1), (1, 1))) + p["Conv_2"]["bias"]
    x = leaky_relu(_group_norm(x, p["GroupNorm2d_2"]["GroupNorm_0"]))

    x = _conv(x, p["Conv_3"]["kernel"], ((1, 1), (1, 1))) + p["Conv_3"]["bias"]
    return torch.relu(x)


def fast_generator_apply(
    params: Dict[str, Any], noise: torch.Tensor, cond: torch.Tensor, int8: bool = False,
    int8_backend: str = "xla", qweights: Optional[Dict[str, Any]] = None,
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    amax_out: Optional[Dict[str, torch.Tensor]] = None, train: bool = False,
) -> torch.Tensor:
    """Forward of ``Generator`` for one expert: ``[B, 56, 30, 1]``.

    ``params`` is the expert's Flax-layout tree of tensors in the compute
    dtype; ``noise`` and ``cond`` are in that dtype too. ``qweights`` are
    :func:`quantize_weights` of ``params`` (computed here when not given).

    ``act_scales``: optional ``{"conv0", "conv1", "conv2"} -> f32 scalar
    tensor``, static activation scales of the XLA backend's quant sites
    (:func:`_quant_act`); the kernel backends quantise per sample inside
    their kernels and do not read them. ``amax_out``: a dict that receives
    the f32 max|x| of each quant site's input under the same keys (the
    calibration capture; the sites that the backend runs in plain PyTorch).
    ``train``: Conv_1 of the float forward as :func:`fused_row_resize_conv4`,
    JAX's form in serving and in training with ``train.fast_generator``
    (``zdcsim/train/step.py:176-182``), which the train step follows. Serving
    keeps the plain resize + conv there: on an H100 80GB HBM3 at 700 W the
    fused form served the teacher 7.0-7.7% slower in ``f32`` and 16-27%
    slower in ``bf16`` at tile 256 (``bench_torch.py --all --tiles 256
    --n-showers 32768``, both dispatch forms, ``PERF.md`` §6). Both fused
    convs differentiate through their naive forms.
    """
    return decode_apply(params, mlp_apply(params, noise, cond), noise.dtype, int8,
                        int8_backend, qweights, act_scales, amax_out, train)
