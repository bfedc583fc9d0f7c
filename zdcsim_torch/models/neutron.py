"""Neutron generators, float path (counterpart of ``zdcsim/models/neutron.py``).

Inputs are ``noise [B, 10]`` and ``cond [B, 9]``; the output is NHWC
``[B, 44, 44, 1]`` log-space intensities, as in JAX. Inside, activations
are NCHW. Submodules carry the Flax names, so ``zdcsim_torch.convert`` maps
the trees by name. Dropout is the identity in eval; the training forms are
not ported (``train=True`` raises).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from zdcsim_torch.models.layers import (
    NORM_EPS, GroupNorm2d, MaskedBatchNorm, MLPBlock, leaky_relu, nearest_index_on,
)
from zdcsim_torch.models.proton import generator_width

NEUTRON_SHAPE = (44, 44)
NORMS = ("batch", "group", "none")


def _not_ported(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "the neutron generators' training forward (dropout, masked BatchNorm statistics) "
            "is not ported yet (ROADMAP.md Queue 1 item 6)")


class GeneratorNeutron(nn.Module):
    """DCGAN-style generator for 44x44 showers (``zdcsim/models/neutron.py:30``):
    FC256 -> FC w(128)*13*13 -> 13x13 -> up x2 -> Conv3x3 w(256) -> up x2 ->
    Conv3x3 w(128) -> Conv2x2 w(64) -> Conv2x2 1 -> ReLU, every conv VALID
    (13 -> 26 -> 24 -> 48 -> 46 -> 45 -> 44), a norm + LeakyReLU(0.1) after
    each layer but the last.

    ``norm="batch"``: ``MaskedBatchNorm_0..4``; ``"group"``: ``LayerNorm_0``,
    ``LayerNorm_1`` after the Dense layers and ``GroupNorm2d_0..2`` after the
    convs (the neutron teacher's layout); ``"none"``: no norms (the distilled
    students, whose tree is the folded serving layout)."""

    def __init__(self, noise_dim: int = 10, cond_dim: int = 9, norm: str = "batch",
                 width: float = 1.0):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        w = lambda c: generator_width(c, width)  # noqa: E731
        self.c0 = w(128)
        self.Dense_0 = nn.Linear(noise_dim + cond_dim, 256)
        self.Dense_1 = nn.Linear(256, self.c0 * 13 * 13)
        self.Conv_0 = nn.Conv2d(self.c0, w(256), 3)
        self.Conv_1 = nn.Conv2d(w(256), w(128), 3)
        self.Conv_2 = nn.Conv2d(w(128), w(64), 2)
        self.Conv_3 = nn.Conv2d(w(64), 1, 2)
        features = (256, self.c0 * 13 * 13, w(256), w(128), w(64))
        # the norm after each of the five layers, by its Flax name
        self.norm_names = []
        for i, f in enumerate(features):
            if norm == "batch":
                name, mod = f"MaskedBatchNorm_{i}", MaskedBatchNorm(f)
            elif norm == "group" and i < 2:
                name, mod = f"LayerNorm_{i}", nn.LayerNorm(f, eps=NORM_EPS)
            elif norm == "group":
                name, mod = f"GroupNorm2d_{i - 2}", GroupNorm2d(f)
            else:
                continue
            self.add_module(name, mod)
            self.norm_names.append(name)

    def _norm_leaky(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.norm_names:
            x = getattr(self, self.norm_names[i])(x)
        return leaky_relu(x)

    def forward(self, noise: torch.Tensor, cond: torch.Tensor, train: bool = False) -> torch.Tensor:
        _not_ported(train)
        x = torch.cat([noise, cond], dim=1)
        x = self._norm_leaky(0, self.Dense_0(x))
        x = self._norm_leaky(1, self.Dense_1(x))
        # the Dense output is laid out (13, 13, C) in HWC order
        x = x.reshape(-1, 13, 13, self.c0).permute(0, 3, 1, 2)
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 26x26
        x = self._norm_leaky(2, self.Conv_0(x))  # 24x24
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 48x48
        x = self._norm_leaky(3, self.Conv_1(x))  # 46x46
        x = self._norm_leaky(4, self.Conv_2(x))  # 45x45
        return torch.relu(self.Conv_3(x)).permute(0, 2, 3, 1)  # 44x44


class GeneratorNeutronV2(nn.Module):
    """The proton recipe on the neutron geometry (``zdcsim/models/neutron.py:117``):
    MLPBlock 256 -> MLPBlock w(512)*12*12 -> 12x12 -> up x2 -> Conv4x4 w(256)
    pad 1 (23x23) -> nearest resize to 44x44 -> Conv4x4 w(128) pad 1 (43x43)
    -> Conv3x3 w(64) pad 1 -> Conv2x2 1 pad 1 (44x44) -> ReLU; GroupNorm2d +
    LeakyReLU(0.1) after each of the first three convs (``norm="group"``),
    or LeakyReLU alone (``"none"``)."""

    def __init__(self, noise_dim: int = 10, cond_dim: int = 9, norm: str = "group",
                 width: float = 1.0):
        super().__init__()
        if norm not in ("group", "none"):
            raise ValueError("GeneratorNeutronV2 supports norm='group'|'none' "
                             f"(got {norm!r}); norm='batch' is GeneratorNeutron")
        w = lambda c: generator_width(c, width)  # noqa: E731
        self.c0 = w(512)
        self.MLPBlock_0 = MLPBlock(noise_dim + cond_dim, 256)
        self.MLPBlock_1 = MLPBlock(256, self.c0 * 12 * 12)
        self.Conv_0 = nn.Conv2d(self.c0, w(256), 4, padding=1)
        self.Conv_1 = nn.Conv2d(w(256), w(128), 4, padding=1)
        self.Conv_2 = nn.Conv2d(w(128), w(64), 3, padding=1)
        self.Conv_3 = nn.Conv2d(w(64), 1, 2, padding=1)
        self.grouped = norm == "group"
        if self.grouped:
            for i, c in enumerate((w(256), w(128), w(64))):
                self.add_module(f"GroupNorm2d_{i}", GroupNorm2d(c))

    def _norm_leaky(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.grouped:
            x = getattr(self, f"GroupNorm2d_{i}")(x)
        return leaky_relu(x)

    def forward(self, noise: torch.Tensor, cond: torch.Tensor, train: bool = False) -> torch.Tensor:
        _not_ported(train)
        x = torch.cat([noise, cond], dim=1)
        x = self.MLPBlock_1(self.MLPBlock_0(x))
        x = x.reshape(-1, 12, 12, self.c0).permute(0, 3, 1, 2)
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 24x24
        x = self._norm_leaky(0, self.Conv_0(x))  # 23x23
        # nearest-exact 23 -> 44, index tensors made on the device
        rows = nearest_index_on(NEUTRON_SHAPE[0], x.shape[2], x.device)
        cols = nearest_index_on(NEUTRON_SHAPE[1], x.shape[3], x.device)
        x = x.index_select(2, rows).index_select(3, cols)
        x = self._norm_leaky(1, self.Conv_1(x))  # 43x43
        x = self._norm_leaky(2, self.Conv_2(x))  # 43x43
        return torch.relu(self.Conv_3(x)).permute(0, 2, 3, 1)  # 44x44
