"""Plain float32 building blocks of the reference models: NHWC tensors, HWIO
kernels, Flax's conventions (LayerNorm and GroupNorm eps 1e-6, BatchNorm eps
1e-5, LeakyReLU slope 0.1, ``jax.image.resize``'s nearest index). Nothing
here imports the program under test.

``fake_quant`` rounds activations per sample and kernels per output channel
to a symmetric grid of ``bits`` bits; the reference runs it at the convs that
the program computes in int8 to give the control of a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
BN_EPS = 1e-5


@contextlib.contextmanager
def ieee_f32():
    """Float32 matmuls and convs without TF32 inside the block: PyTorch's
    per-backend ``fp32_precision`` set to ``"ieee"`` where it has them (the
    legacy ``allow_tf32`` flags leave channels-last convs in TF32 there),
    else the legacy flags off."""
    b = torch.backends
    conv = getattr(b.cudnn, "conv", None)
    if hasattr(conv, "fp32_precision"):
        knobs = [(b.cuda.matmul, "fp32_precision", "ieee"), (conv, "fp32_precision", "ieee")]
    else:
        knobs = [(b.cuda.matmul, "allow_tf32", False), (b.cudnn, "allow_tf32", False)]
    saved = [getattr(o, a) for o, a, _ in knobs]
    for o, a, v in knobs:
        setattr(o, a, v)
    try:
        yield
    finally:
        for (o, a, _), v in zip(knobs, saved):
            setattr(o, a, v)


def leaky(x):
    return F.leaky_relu(x, 0.1)


def layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + NORM_EPS) * p["scale"] + p["bias"]


def groups_of(c: int, groups: int = 32) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def group_norm(x, p):
    b, h, w, c = x.shape
    g = groups_of(c)
    xg = x.reshape(b, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    return ((xg - mu) / torch.sqrt(var + NORM_EPS)).reshape(b, h, w, c) * p["scale"] + p["bias"]


def batch_norm_eval(x, p, stats):
    return (x - stats["mean"]) / torch.sqrt(stats["var"] + BN_EPS) * p["scale"] + p["bias"]


def dense(x, p):
    return x @ p["kernel"] + p["bias"]


def fake_quant(x, bits: Optional[int], dims):
    """``x`` rounded to a symmetric ``bits``-bit grid whose step is the max
    of ``|x|`` over ``dims`` (the others keep a scale each); ``None``: ``x``."""
    if bits is None:
        return x
    q = 2 ** (bits - 1) - 1
    s = torch.clamp(x.abs().amax(dim=dims, keepdim=True) / q, min=1e-12)
    return torch.clamp(torch.round(x / s), -q, q) * s


def conv(x, kernel, bias, pad, bits: Optional[int] = None, per_tensor: bool = False):
    """NHWC x HWIO cross-correlation, ``pad = (top, bottom, left, right)``;
    with ``bits``, both operands on the grid of :func:`fake_quant`: the
    input's step set per sample, or over all of ``x`` (``per_tensor``)."""
    x = fake_quant(x, bits, (0, 1, 2, 3) if per_tensor else (1, 2, 3))
    kernel = fake_quant(kernel, bits, (0, 1, 2))
    xt = F.pad(x.permute(0, 3, 1, 2), (pad[2], pad[3], pad[0], pad[1]))
    y = F.conv2d(xt, kernel.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return y + bias


def nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """``floor((i + 0.5) * n_in / n_out)``: ``jax.image.resize``'s nearest."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def resize_nearest(x, size):
    _, h, w, _ = x.shape
    x = x.index_select(1, nearest_index(size[0], h, x.device))
    return x.index_select(2, nearest_index(size[1], w, x.device))


def upsample2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def router_v1(p, cond):
    """``router_v1``'s logits: Dense layers with LeakyReLU between."""
    n = len(p)
    x = cond
    for i in range(n):
        x = dense(x, p[f"Dense_{i}"])
        if i < n - 1:
            x = leaky(x)
    return x


def router_tree_leaves(cfg):
    """``router_v1``'s leaves: Dense layers ``cond -> widths -> experts``."""
    dims = [int(cfg["model.cond_dim"]), *cfg["model.router.widths"], int(cfg["model.n_experts"])]
    out = []
    for i in range(len(dims) - 1):
        out += [((f"Dense_{i}", "kernel"), (dims[i], dims[i + 1]), "lecun"),
                ((f"Dense_{i}", "bias"), (dims[i + 1],), "zeros")]
    return out
