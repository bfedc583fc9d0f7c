"""Proton generator, float path (counterpart of ``zdcsim/models/proton.py:27``).

The reference for the fast int8 decode in ``proton_fast``. Inputs are
``noise [B, 10]`` and ``cond [B, 9]``; the output is NHWC ``[B, 56, 30, 1]``
log-space intensities, as in JAX. Inside, activations are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from zdcsim_torch.models.layers import GroupNorm2d, MLPBlock, leaky_relu, nearest_index

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
        x = x.index_select(2, rows).index_select(3, cols)  # 56x30
        x = leaky_relu(self.GroupNorm2d_1(self.Conv_1(x)))  # 55x29
        x = leaky_relu(self.GroupNorm2d_2(self.Conv_2(x)))  # 55x29
        x = torch.relu(self.Conv_3(x))  # 56x30
        return x.permute(0, 2, 3, 1)
