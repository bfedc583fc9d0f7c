"""Shared building blocks (counterpart of ``zdcsim/models/layers.py``).

Functions take NHWC tensors, as the JAX package does. The modules hold their
weights in PyTorch's layout under the Flax names (``Dense_0``,
``LayerNorm_0``, ...) so that ``zdcsim_torch.convert`` maps one tree onto
the other by name. LayerNorm and GroupNorm use Flax's eps of 1e-6, not
PyTorch's 1e-5; ``MaskedBatchNorm`` keeps its own 1e-5.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-6
BN_EPS = 1e-5  # MaskedBatchNorm.epsilon (zdcsim/models/layers.py:138)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def upsample_nearest(x: torch.Tensor, scale: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NHWC tensor by integer factors
    (``repeat_interleave`` with int counts: no index tensor, nothing read
    from the host)."""
    return x.repeat_interleave(scale[0], dim=1).repeat_interleave(scale[1], dim=2)


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each output position, ``floor((i + 0.5) * n_in / n_out)``
    (``jax.image.resize(method='nearest')``; PyTorch's ``nearest-exact``)."""
    return np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.int64)


def nearest_index_on(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    """:func:`nearest_index` computed on ``device`` in float64 (equal to the
    numpy one): no copy from the host, so a CUDA graph can hold it."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).to(torch.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC tensor to ``size`` by gathering
    rows and columns (exact in every dtype, int8 included)."""
    _, h, w, _ = x.shape
    rows = nearest_index_on(size[0], h, x.device)
    cols = nearest_index_on(size[1], w, x.device)
    return x.index_select(1, rows).index_select(2, cols)


def group_norm_groups(channels: int, groups: int = 32) -> int:
    """Largest group count <= ``groups`` dividing ``channels``."""
    g = min(groups, channels)
    while channels % g != 0 and g > 1:
        g -= 1
    return g


class MLPBlock(nn.Module):
    """Dense + LayerNorm + LeakyReLU(0.1)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.LayerNorm_0 = nn.LayerNorm(features, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.LayerNorm_0(self.Dense_0(x)))


class GroupNorm2d(nn.Module):
    """GroupNorm with the divisor-adjusted group count, on NCHW input."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(
            group_norm_groups(channels, groups), channels, eps=NORM_EPS
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class MaskedBatchNorm(nn.Module):
    """Eval form of the JAX ``MaskedBatchNorm`` (``zdcsim/models/layers.py:98``):
    ``(x - mean) * rsqrt(var + 1e-5) * scale + bias`` per feature, computed in
    float32 and cast back to the input's dtype. ``weight``/``bias`` hold
    Flax's ``scale``/``bias``; the buffers ``running_mean``/``running_var``
    hold its ``batch_stats`` ``mean``/``var``. Flax stores the biased
    variance, and eval uses it as stored. The feature axis is 1 (``[B, C]``
    or NCHW ``[B, C, H, W]``).

    The training form (masked sub-batch statistics) is not ported:
    ``train=True`` raises.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "MaskedBatchNorm's training form (masked sub-batch statistics) is not ported "
                "yet (ROADMAP.md Queue 1 item 6)")
        f32 = lambda t: t.to(torch.float32)  # noqa: E731
        y = F.batch_norm(f32(x), f32(self.running_mean), f32(self.running_var), f32(self.weight),
                         f32(self.bias), training=False, eps=BN_EPS)
        return y.to(x.dtype)
