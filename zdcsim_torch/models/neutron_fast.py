"""Serving forward of the neutron generator, float and int8 (counterpart of
``zdcsim/models/neutron_fast.py``).

In eval every ``MaskedBatchNorm`` of ``GeneratorNeutron(norm="batch")`` is a
fixed per-feature affine, so :func:`fold_neutron_params` folds all five into
the preceding Dense or conv. A ``norm="none"`` student's tree is already in
that layout (:func:`is_prefolded`). :func:`fast_neutron_apply` serves the
folded tree: the 2x nearest upsamples are materialised and the convs run as
plain VALID convs; with ``int8=True`` Conv_0, Conv_1 and Conv_2 run on int8
operands with int32 sums (``proton_fast._conv_i8``), weights quantised per
output channel and activations per tensor (the dynamic max of the call, or a
static calibrated scale), dequantised in float32. The JAX neutron path runs
no Pallas kernel, so none of the port's CUDA kernels is launched here.

Activations are NHWC and kernels HWIO at every function boundary, as in JAX.
Nothing here reads to the host or builds an index tensor, so a CUDA graph
can hold the whole forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from zdcsim_torch.models.layers import BN_EPS, leaky_relu, upsample_nearest
from zdcsim_torch.models.proton_fast import QWeights, _conv, _conv_i8, _quant_act, _quant_per_cout

_FOLD_PAIRS = (
    ("Dense_0", "MaskedBatchNorm_0"),
    ("Dense_1", "MaskedBatchNorm_1"),
    ("Conv_0", "MaskedBatchNorm_2"),
    ("Conv_1", "MaskedBatchNorm_3"),
    ("Conv_2", "MaskedBatchNorm_4"),
)
_FOLDED_KEYS = frozenset([layer for layer, _ in _FOLD_PAIRS] + ["Conv_3"])

# int8 for the three inner convs (the JAX module's toggles, all on)
INT8_CONV0 = True
INT8_CONV1 = True
INT8_CONV2 = True
_INT8_CONVS = {"Conv_0": INT8_CONV0, "Conv_1": INT8_CONV1, "Conv_2": INT8_CONV2}


def is_foldable(params: Dict[str, Any]) -> bool:
    """True when the tree holds the BatchNorm layers the fold expects
    (``norm="batch"``)."""
    return all(bn in params for _, bn in _FOLD_PAIRS)


def is_prefolded(params: Dict[str, Any]) -> bool:
    """True when the tree is already the folded serving layout: a
    ``GeneratorNeutron(norm="none")`` student (Dense_0, Dense_1, Conv_0..3,
    kernel and bias only)."""
    return set(params) == _FOLDED_KEYS and all(
        set(params[k]) == {"kernel", "bias"} for k in _FOLDED_KEYS)


def fold_neutron_params(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> Dict[str, Any]:
    """Fold each eval BatchNorm into the layer before it, in float32:
    ``g = scale * rsqrt(var + 1e-5)``, ``kernel * g`` and ``(bias - mean) * g
    + beta`` (``g`` is per output channel, so the fold commutes with the
    conv). One expert's tree (tensors) and its ``batch_stats`` collection
    ``{MaskedBatchNorm_i: {mean, var}}`` -> ``{Dense_0, Dense_1, Conv_0..2
    folded, Conv_3 as it is}``."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    out = {}
    for layer, bn in _FOLD_PAIRS:
        g = f32(params[bn]["scale"]) * torch.rsqrt(f32(batch_stats[bn]["var"]) + BN_EPS)
        out[layer] = {
            "kernel": f32(params[layer]["kernel"]) * g,
            "bias": (f32(params[layer]["bias"]) - f32(batch_stats[bn]["mean"])) * g
            + f32(params[bn]["bias"]),
        }
    out["Conv_3"] = {k: f32(v) for k, v in params["Conv_3"].items()}
    return out


def quantize_neutron_weights(p: Dict[str, Any]) -> Dict[str, QWeights]:
    """One expert's per-output-channel int8 conv weights for
    :func:`fast_neutron_apply`, computed once per weight set (JAX hoists the
    same work out of its loops)."""
    return {name: _quant_per_cout(p[name]["kernel"]) for name, on in _INT8_CONVS.items() if on}


def _conv_valid(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _conv(x, k.to(x.dtype), ((0, 0), (0, 0))) + b.to(x.dtype)


def _conv_valid_int8(x: torch.Tensor, q: QWeights, b: torch.Tensor,
                     act_scale: Optional[torch.Tensor] = None, up2: bool = False) -> torch.Tensor:
    """VALID conv on int8 operands: per-tensor activation scale (dynamic, or
    ``act_scale``), ``q = _quant_per_cout(kernel)``, int32 sums, float32
    dequant. ``up2``: upsample the quantised activations 2x first (the
    per-tensor max does not change under duplication, so the scale is the
    one of quantising after)."""
    xq, sx = _quant_act(x, act_scale)
    if up2:
        xq = upsample_nearest(xq)
    kq, sk = q
    y = _conv_i8(xq, kq, ((0, 0), (0, 0)))  # JAX's _up2_conv_valid_int8 when up2
    return (y.to(torch.float32) * (sk * sx) + b.to(torch.float32)).to(x.dtype)


def fast_neutron_apply(
    folded: Dict[str, Any], noise: torch.Tensor, cond: torch.Tensor, int8: bool = False,
    qweights: Optional[Dict[str, QWeights]] = None,
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    amax_out: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Eval forward of ``GeneratorNeutron`` from a folded (or prefolded)
    tree of one expert: ``[B, 44, 44, 1]`` log-space pixels in the dtype of
    ``noise``. The channel count comes from the tree, so the width-scaled
    students serve too.

    ``qweights``: :func:`quantize_neutron_weights` of ``folded`` (computed
    here when ``int8`` and not given). ``act_scales``: optional static f32
    scales of the quant sites ``conv0``, ``conv1``, ``conv2``; ``amax_out``:
    a dict that receives the f32 max|x| of each site's input (the
    calibration capture), as ``proton_fast.fast_generator_apply``."""
    p = folded
    scales = act_scales or {}
    if int8 and qweights is None:
        qweights = quantize_neutron_weights(p)

    def site(t, name):
        if amax_out is not None:
            amax_out[name] = t.to(torch.float32).abs().amax()
        return t

    x = torch.cat([noise, cond], dim=1)
    for name in ("Dense_0", "Dense_1"):
        x = leaky_relu(x @ p[name]["kernel"].to(x.dtype) + p[name]["bias"].to(x.dtype))
    x = x.reshape(-1, 13, 13, p["Dense_1"]["kernel"].shape[-1] // (13 * 13))

    for name, s, up in (("Conv_0", "conv0", True), ("Conv_1", "conv1", True),
                        ("Conv_2", "conv2", False)):
        x = site(x, s)
        if int8 and _INT8_CONVS[name]:
            x = _conv_valid_int8(x, qweights[name], p[name]["bias"], scales.get(s), up2=up)
        else:
            x = _conv_valid(upsample_nearest(x) if up else x, p[name]["kernel"], p[name]["bias"])
        x = leaky_relu(x)  # 24x24, 46x46, 45x45

    x = _conv_valid(x, p["Conv_3"]["kernel"], p["Conv_3"]["bias"])  # 44x44x1
    return torch.relu(x)
