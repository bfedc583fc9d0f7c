"""Fast proton generator forward, float and int8 (counterpart of
``zdcsim/models/proton_fast.py``).

:func:`fast_generator_apply` runs ``Generator``'s forward from the Flax
layout parameter tree of one expert (tensors; see ``zdcsim_torch.convert``)
with Conv_0 as four parity-phase convs on the 18x10 grid instead of a 4x4
conv on the upsampled 36x20 grid. Activations are NHWC and kernels HWIO at
every function boundary, as in JAX.

int8 (``int8=True``): symmetric int8 with ``round`` half to even and a clip
at +-127; weights per output channel, activations per tensor (the XLA
backend) or per sample (the kernels of the ``pallas_ab`` backend).

- ``int8_backend="xla"``: every int8 stage is plain PyTorch.
- ``int8_backend="pallas_ab"``: the MLP's LayerNorm + LeakyReLU + quant and
  Conv_0 run on the two CUDA kernels that replace Pallas kernels A and B
  (``zdcsim_torch.ops.decode_kernels``); Conv_1 and Conv_2 stay plain.

The plain int8 convs (:func:`_conv_i8`) sum the int8 values in float32
(cuDNN on the GPU, with TF32 off for the call): exact up to float32
summation, where JAX sums in int32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from zdcsim_torch.models.layers import group_norm_groups, leaky_relu, resize_nearest
from zdcsim_torch.ops import decode_kernels as dk

QWeights = Tuple[torch.Tensor, torch.Tensor]


@contextlib.contextmanager
def _no_tf32():
    """cuDNN float32 convs in full float32 for the enclosed calls only."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _conv(x: torch.Tensor, k: torch.Tensor, pad) -> torch.Tensor:
    """NHWC x HWIO cross-correlation, ``pad = ((top, bottom), (left, right))``."""
    xt = F.pad(x.permute(0, 3, 1, 2), (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    return F.conv2d(xt, k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def _conv_i8(xq: torch.Tensor, kq: torch.Tensor, pad) -> torch.Tensor:
    """Conv of int8 values with int8 weights in float32 (the JAX ``_conv_i8``
    sums in int32). A direct float32 sum equals it up to float32 summation;
    on the card cuDNN may pick an FFT algorithm instead, whose rounding is
    not that of a direct sum (it does so for Conv_1 on the H100)."""
    with _no_tf32():
        return _conv(xq.to(torch.float32), kq.to(torch.float32), pad)


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


def fused_upsample2_conv4(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv4x4(pad1, nearest_up2(x))`` without materialising the upsample:
    x ``[B, H, W, Cin]``, kernel HWIO ``[4, 4, Cin, Cout]`` ->
    ``[B, 2H-1, 2W-1, Cout]``."""
    return _phase_convs(x, dk._phase_kernels(kernel), _conv) + bias


def _quant_per_cout(k: torch.Tensor):
    """Per-output-channel symmetric int8 of a kernel: ``(q, s [cout])``."""
    k = k.to(torch.float32)
    s = torch.clamp(k.abs().amax(dim=tuple(range(k.ndim - 1))) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(k / s), -127, 127).to(torch.int8)
    return q, s


def _quant_act(x: torch.Tensor):
    """Per-tensor symmetric int8 of activations, with the dynamic scale of one
    max over the tensor (static calibrated scales are not ported yet)."""
    x = x.to(torch.float32)
    s = torch.clamp(x.abs().amax() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def _dequant(y, sk, sx, bias, dtype):
    """``y * (sk * sx) + bias`` in float32, cast to ``dtype``."""
    return (y * (sk * sx) + bias.to(torch.float32)).to(dtype)


def conv3x3_int8(x: torch.Tensor, q: QWeights, bias: torch.Tensor) -> torch.Tensor:
    """Pad-1 3x3 conv on int8 data: ``q = _quant_per_cout(kernel)``."""
    xq, sx = _quant_act(x)
    kq, sk = q
    return _dequant(_conv_i8(xq, kq, ((1, 1), (1, 1))), sk, sx, bias, x.dtype)


def quant_conv0_phases(kernel: torch.Tensor) -> Dict[str, QWeights]:
    """The XLA int8 Conv_0 weights: merged in the kernel's own dtype, then each
    phase kernel quantized per output channel (as
    ``zdcsim.models.proton_fast.fused_upsample2_conv4_int8`` does)."""
    return {name: _quant_per_cout(k) for name, k in dk._phase_kernels(kernel).items()}


def fused_upsample2_conv4_int8(x: torch.Tensor, q: Dict[str, QWeights],
                               bias: torch.Tensor) -> torch.Tensor:
    """int8 :func:`fused_upsample2_conv4` with one per-tensor activation
    scale; ``q = quant_conv0_phases(kernel)``."""
    xq, sx = _quant_act(x)

    def qconv(x_, k, pad):
        kq, sk = k
        return _conv_i8(x_, kq, pad) * (sk * sx)

    out = _phase_convs(xq, q, qconv)
    return (out + bias.to(torch.float32)).to(x.dtype)


def resize_conv4_int8_naive(x: torch.Tensor, q: QWeights, bias: torch.Tensor,
                            n_resized_rows: int, n_cols: int) -> torch.Tensor:
    """Nearest resize of the int8 activations, then one plain 4x4 pad-1 conv:
    ``q = _quant_per_cout(kernel)``."""
    xq, sx = _quant_act(x)
    xr = resize_nearest(xq, (n_resized_rows, n_cols))
    kq, sk = q
    return _dequant(_conv_i8(xr, kq, ((1, 1), (1, 1))), sk, sx, bias, x.dtype)


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


def quantize_weights(p: Dict[str, Any], int8_backend: str = "xla") -> Dict[str, Any]:
    """One expert's int8 weights for :func:`fast_generator_apply`, computed
    once per weight set (JAX hoists the same work out of its loops)."""
    q = {
        "conv1": _quant_per_cout(p["Conv_1"]["kernel"]),
        "conv2": _quant_per_cout(p["Conv_2"]["kernel"]),
    }
    if int8_backend == "pallas_ab":
        # the kernels take their per-channel parameters in float32
        ln = p["MLPBlock_1"]["LayerNorm_0"]
        q["ln1"] = (ln["scale"].to(torch.float32), ln["bias"].to(torch.float32))
        q["conv0"] = dk._quant_phases(p["Conv_0"]["kernel"])
        q["conv0_bias"] = p["Conv_0"]["bias"].to(torch.float32)
    elif int8_backend == "xla":
        q["conv0"] = quant_conv0_phases(p["Conv_0"]["kernel"])
    else:
        raise ValueError(f"int8_backend must be 'xla' or 'pallas_ab', got {int8_backend!r}")
    return q


def fast_generator_apply(
    params: Dict[str, Any], noise: torch.Tensor, cond: torch.Tensor, int8: bool = False,
    int8_backend: str = "xla", qweights: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Inference forward of ``Generator`` for one expert: ``[B, 56, 30, 1]``.

    ``params`` is the expert's Flax-layout tree of tensors in the compute
    dtype; ``noise`` and ``cond`` are in that dtype too. ``qweights`` are
    :func:`quantize_weights` of ``params`` (computed here when not given).
    """
    p = params
    if int8 and qweights is None:
        qweights = quantize_weights(p, int8_backend)
    use_kernels = int8 and int8_backend == "pallas_ab"

    x = torch.cat([noise, cond], dim=1)
    bp0 = p["MLPBlock_0"]
    x = x @ bp0["Dense_0"]["kernel"] + bp0["Dense_0"]["bias"]
    x = leaky_relu(_layer_norm(x, bp0["LayerNorm_0"]))
    bp1 = p["MLPBlock_1"]
    x = x @ bp1["Dense_0"]["kernel"] + bp1["Dense_0"]["bias"]
    c0 = bp1["Dense_0"]["kernel"].shape[1] // (18 * 10)
    if use_kernels:
        xq, sx = dk.ln_leaky_rowquant(x, *qweights["ln1"])
        kq, sk = qweights["conv0"]
        x = dk.up2_conv4_int8(
            xq.reshape(-1, 18, 10, c0), sx, kq, sk, qweights["conv0_bias"],
            out_dtype=noise.dtype,
        )
    else:
        x = leaky_relu(_layer_norm(x, bp1["LayerNorm_0"]))
        x = x.reshape(-1, 18, 10, c0)
        if int8:
            x = fused_upsample2_conv4_int8(x, qweights["conv0"], p["Conv_0"]["bias"])
        else:
            x = fused_upsample2_conv4(x, p["Conv_0"]["kernel"], p["Conv_0"]["bias"])
    x = leaky_relu(_group_norm(x, p["GroupNorm2d_0"]["GroupNorm_0"]))

    # resize 35x19 -> 56x30 + Conv_1 4x4 pad 1 -> 55x29
    if int8:
        x = resize_conv4_int8_naive(x, qweights["conv1"], p["Conv_1"]["bias"], 56, 30)
    else:
        x = _conv(resize_nearest(x, (56, 30)), p["Conv_1"]["kernel"], ((1, 1), (1, 1)))
        x = x + p["Conv_1"]["bias"]
    x = leaky_relu(_group_norm(x, p["GroupNorm2d_1"]["GroupNorm_0"]))

    if int8:
        x = conv3x3_int8(x, qweights["conv2"], p["Conv_2"]["bias"])
    else:
        x = _conv(x, p["Conv_2"]["kernel"], ((1, 1), (1, 1))) + p["Conv_2"]["bias"]
    x = leaky_relu(_group_norm(x, p["GroupNorm2d_2"]["GroupNorm_0"]))

    x = _conv(x, p["Conv_3"]["kernel"], ((1, 1), (1, 1))) + p["Conv_3"]["bias"]
    return torch.relu(x)
