"""Proton family (counterpart of ``zdcsim/models/proton.py``).

The float ``Generator`` is the reference for the fast int8 decode in
``proton_fast`` and the generator of training; ``Discriminator`` and
``AuxReg`` are the training family's other two. Images in and out are NHWC
(``[B, 56, 30, 1]`` log-space intensities), as in JAX; inside, activations
are NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zdcsim_torch.models.layers import (
    NORM_EPS, GroupNorm2d, MLPBlock, SNConv, SNDense, dropout, gather_nearest, leaky_relu,
    max_pool, nearest_index, same_pads,
)

PROTON_SHAPE = (56, 30)


def generator_width(c: int, width: float) -> int:
    """Channel count at ``width``: rounded down to a multiple of 32, at least 32
    (``zdcsim/models/proton.py:50``)."""
    return max(32, int(c * width) // 32 * 32)


class Generator(nn.Module):
    """concat(noise, cond) -> FC256 -> FC w(512)*18*10 -> 18x10 -> up x2 ->
    Conv4x4 w(256) (GN) -> resize 56x30 -> Conv4x4 w(128) (GN) -> Conv3x3
    w(64) (GN) -> Conv2x2 1 (pad 1) -> ReLU."""

    def __init__(self, noise_dim: int = 10, cond_dim: int = 9, width: float = 1.0):
        super().__init__()
        w = lambda c: generator_width(c, width)  # noqa: E731
        self.c0 = w(512)
        self.MLPBlock_0 = MLPBlock(noise_dim + cond_dim, 256)
        self.MLPBlock_1 = MLPBlock(256, self.c0 * 18 * 10)
        self.Conv_0 = nn.Conv2d(self.c0, w(256), 4, padding=1)
        self.GroupNorm2d_0 = GroupNorm2d(w(256))
        self.Conv_1 = nn.Conv2d(w(256), w(128), 4, padding=1)
        self.GroupNorm2d_1 = GroupNorm2d(w(128))
        self.Conv_2 = nn.Conv2d(w(128), w(64), 3, padding=1)
        self.GroupNorm2d_2 = GroupNorm2d(w(64))
        self.Conv_3 = nn.Conv2d(w(64), 1, 2, padding=1)

    def forward(self, noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = torch.cat([noise, cond], dim=1)
        x = self.MLPBlock_1(self.MLPBlock_0(x))
        # the Dense output is laid out (18, 10, C) in HWC order
        x = x.reshape(-1, 18, 10, self.c0).permute(0, 3, 1, 2)
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 36x20
        x = leaky_relu(self.GroupNorm2d_0(self.Conv_0(x)))  # 35x19
        rows = torch.from_numpy(nearest_index(PROTON_SHAPE[0], x.shape[2])).to(x.device)
        cols = torch.from_numpy(nearest_index(PROTON_SHAPE[1], x.shape[3])).to(x.device)
        x = gather_nearest(gather_nearest(x, 2, rows), 3, cols)  # 56x30
        x = leaky_relu(self.GroupNorm2d_1(self.Conv_1(x)))  # 55x29
        x = leaky_relu(self.GroupNorm2d_2(self.Conv_2(x)))  # 55x29
        x = torch.relu(self.Conv_3(x))  # 56x30
        return x.permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """Hinge discriminator with spectral norm (``zdcsim/models/proton.py:74``):
    SN Conv3x3 32 (GN 8 groups) -> pool 2x2 -> SN Conv3x3 16 (GN 8) -> pool
    (2, 1) -> flatten in NHWC order ++ cond -> SN FC128 (LN) -> SN FC64 (LN) =
    latent -> SN FC1. ``forward(img, cond, stats, train)`` returns ``(score
    [B, 1], latent [B, 64], new stats)`` (see ``layers._SpectralNorm``)."""

    def __init__(self, cond_dim: int = 9, image_shape: Tuple[int, int] = PROTON_SHAPE):
        super().__init__()
        h, w = image_shape
        h, w = (h - 2) // 2, (w - 2) // 2  # SN conv 3x3 VALID, pool 2x2
        h, w = (h - 2) // 2, w - 2  # SN conv 3x3 VALID, pool (2, 1)
        self.SNConv_0 = SNConv(1, 32, 3, "SNConv_0")
        self.GroupNorm2d_0 = GroupNorm2d(32, groups=8)
        self.SNConv_1 = SNConv(32, 16, 3, "SNConv_1")
        self.GroupNorm2d_1 = GroupNorm2d(16, groups=8)
        self.SNDense_0 = SNDense(16 * h * w + cond_dim, 128, "SNDense_0")
        self.LayerNorm_0 = nn.LayerNorm(128, eps=NORM_EPS)
        self.SNDense_1 = SNDense(128, 64, "SNDense_1")
        self.LayerNorm_1 = nn.LayerNorm(64, eps=NORM_EPS)
        self.SNDense_2 = SNDense(64, 1, "SNDense_2")

    def forward(self, img: torch.Tensor, cond: torch.Tensor, stats: Dict[str, torch.Tensor],
                train: bool = True):
        new: Dict[str, torch.Tensor] = {}

        def sn(layer, x):
            y, s = layer(x, stats, train)
            new.update(s)
            return y

        x = img.permute(0, 3, 1, 2)
        x = max_pool(leaky_relu(self.GroupNorm2d_0(sn(self.SNConv_0, x))), (2, 2))  # 27x14
        x = max_pool(leaky_relu(self.GroupNorm2d_1(sn(self.SNConv_1, x))), (2, 1))  # 12x12
        # the SNDense_0 kernel reads the features in JAX's NHWC order
        x = torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), cond], dim=1)
        x = leaky_relu(self.LayerNorm_0(sn(self.SNDense_0, x)))
        latent = leaky_relu(self.LayerNorm_1(sn(self.SNDense_1, x)))
        return sn(self.SNDense_2, latent), latent, new


class ResidualBlock(nn.Module):
    """GroupNorm residual block (``zdcsim/models/proton.py:113``). The
    identity path's 1x1 conv, present when the stride or the width changes,
    pads as Flax's ``"SAME"`` (``same_pads``), which is zero at the proton
    shapes."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 strides: int = 1):
        super().__init__()
        p = kernel_size // 2
        self.strides = strides
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size, stride=strides, padding=p)
        self.GroupNorm2d_0 = GroupNorm2d(features)
        self.Conv_1 = nn.Conv2d(features, features, kernel_size, padding=p)
        self.GroupNorm2d_1 = GroupNorm2d(features)
        self.project = strides != 1 or in_features != features
        if self.project:
            self.Conv_2 = nn.Conv2d(in_features, features, 1, stride=strides)
            self.GroupNorm2d_2 = GroupNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm2d_0(self.Conv_0(x)))
        y = self.GroupNorm2d_1(self.Conv_1(y))
        identity = x
        if self.project:
            (ht, hb), (wl, wr) = (same_pads(n, 1, self.strides) for n in x.shape[2:])
            identity = self.GroupNorm2d_2(self.Conv_2(F.pad(x, (wl, wr, ht, hb))))
        return torch.relu(y + identity)


class AuxReg(nn.Module):
    """(max_x, max_y) regressor (``zdcsim/models/proton.py:136``): Conv5x5 s2
    (GN 8) -> pool s1 -> two stride-2 residual blocks, each with a pool s1
    after it -> global mean -> FC128 (LN, Dropout 0.3) -> FC64 (LN, Dropout
    0.3) -> FC2. ``forward(img, keep)``: ``keep`` holds the two dropout keep
    masks (``[B, 128]``, ``[B, 64]``, bool; shapes in
    :attr:`dropout_shapes`), or ``None`` for the eval form."""

    dropout_shapes = ((128,), (64,))
    rate = 0.3

    def __init__(self, output_dim: int = 2):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 32, 5, stride=2, padding=1)
        self.GroupNorm2d_0 = GroupNorm2d(32, groups=8)
        self.ResidualBlock_0 = ResidualBlock(32, 32, kernel_size=5, strides=2)
        self.ResidualBlock_1 = ResidualBlock(32, 64, kernel_size=5, strides=2)
        self.Dense_0 = nn.Linear(64, 128)
        self.LayerNorm_0 = nn.LayerNorm(128, eps=NORM_EPS)
        self.Dense_1 = nn.Linear(128, 64)
        self.LayerNorm_1 = nn.LayerNorm(64, eps=NORM_EPS)
        self.Dense_2 = nn.Linear(64, output_dim)

    def forward(self, img: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if img.ndim == 3:
            img = img[..., None]
        x = img.permute(0, 3, 1, 2)
        x = max_pool(torch.relu(self.GroupNorm2d_0(self.Conv_0(x))), (2, 2), (1, 1))  # 26x13
        x = max_pool(self.ResidualBlock_0(x), (2, 2), (1, 1))  # 12x6
        x = max_pool(self.ResidualBlock_1(x), (2, 2), (1, 1))  # 5x2
        y = x.mean(dim=(2, 3))  # [B, 64]
        k0, k1 = (None, None) if keep is None else keep
        y = dropout(leaky_relu(self.LayerNorm_0(self.Dense_0(y))), k0, self.rate)
        y = dropout(leaky_relu(self.LayerNorm_1(self.Dense_1(y))), k1, self.rate)
        return self.Dense_2(y)
