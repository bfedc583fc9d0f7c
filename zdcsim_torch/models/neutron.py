"""Neutron family (counterpart of ``zdcsim/models/neutron.py``): the two
generators, ``DiscriminatorNeutron`` and ``AuxRegNeutron``.

Generator inputs are ``noise [B, 10]`` and ``cond [B, 9]``; images in and
out are NHWC (``[B, 44, 44, 1]`` log-space intensities), as in JAX. Inside,
activations are NCHW. Submodules carry the Flax names, so
``zdcsim_torch.convert`` maps the trees by name.

Training forms: dropout takes its keep masks as inputs (``layers.dropout``;
``keep[i]`` bool of the ``i``-th Dropout's input, in JAX's NHWC shape
:attr:`dropout_shapes` after the batch axis), and under ``norm="batch"``
each ``MaskedBatchNorm`` takes the expert's routing mask and returns its new
running statistics, keyed by their Flax ``batch_stats`` paths joined by
``|`` (``MaskedBatchNorm_0|mean``); the old ones are the modules' buffers,
which ``functional_call`` supplies. A module with a training form has
``train_form = True``: its forward takes ``train``, the keep masks and the
mask, and in training returns ``(output, new statistics)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zdcsim_torch.models.layers import (
    NORM_EPS, GroupNorm2d, MaskedBatchNorm, MLPBlock, dropout, gather_nearest, leaky_relu,
    max_pool, nearest_index_on,
)
from zdcsim_torch.models.proton import Discriminator, generator_width

NEUTRON_SHAPE = (44, 44)
NORMS = ("batch", "group", "none")
DROPOUT_RATE = 0.2

Stats = Dict[str, torch.Tensor]


def _norm_layers(module: nn.Module, norm: str, layers: Sequence[Tuple[int, bool]]) -> list:
    """Add the norm after each layer of ``layers`` (``(features, is a conv)``)
    under its Flax name: ``MaskedBatchNorm_i`` (``"batch"``), ``LayerNorm_i``
    after a Dense layer or ``GroupNorm2d_j`` after a conv (``"group"``),
    none (``"none"``). Returns the names, in order."""
    names, n_ln, n_gn = [], 0, 0
    for i, (c, conv) in enumerate(layers):
        if norm == "batch":
            name, mod = f"MaskedBatchNorm_{i}", MaskedBatchNorm(c)
        elif norm == "group" and conv:
            name, mod, n_gn = f"GroupNorm2d_{n_gn}", GroupNorm2d(c), n_gn + 1
        elif norm == "group":
            name, mod, n_ln = f"LayerNorm_{n_ln}", nn.LayerNorm(c, eps=NORM_EPS), n_ln + 1
        else:
            continue
        module.add_module(name, mod)
        names.append(name)
    return names


def _nchw(keep: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A keep mask in JAX's NHWC as the NCHW activation's (a view)."""
    return keep.permute(0, 3, 1, 2) if keep is not None and keep.ndim == 4 else keep


class _Normed(nn.Module):
    """The norm step of the neutron modules: the ``i``-th norm in eval or
    training form, collecting a ``MaskedBatchNorm``'s new statistics."""

    norm_names: list

    def _norm(self, i: int, x: torch.Tensor, train: bool, mask: Optional[torch.Tensor],
              new: Stats) -> torch.Tensor:
        if not self.norm_names:
            return x
        name = self.norm_names[i]
        layer = getattr(self, name)
        if not isinstance(layer, MaskedBatchNorm):
            return layer(x)
        if not train:
            return layer(x, False)
        x, new[f"{name}|mean"], new[f"{name}|var"] = layer(x, True, mask)
        return x


class GeneratorNeutron(_Normed):
    """DCGAN-style generator for 44x44 showers (``zdcsim/models/neutron.py:30``):
    FC256 -> FC w(128)*13*13 -> 13x13 -> up x2 -> Conv3x3 w(256) -> up x2 ->
    Conv3x3 w(128) -> Conv2x2 w(64) -> Conv2x2 1 -> ReLU, every conv VALID
    (13 -> 26 -> 24 -> 48 -> 46 -> 45 -> 44), a norm, ``Dropout(0.2)`` and
    LeakyReLU(0.1) after each layer but the last (dropout before the
    activation).

    ``norm="batch"``: ``MaskedBatchNorm_0..4``; ``"group"``: ``LayerNorm_0``,
    ``LayerNorm_1`` after the Dense layers and ``GroupNorm2d_0..2`` after the
    convs (the neutron teacher's layout); ``"none"``: no norms (the distilled
    students, whose tree is the folded serving layout).

    ``forward(noise, cond, train=False, keep=None, mask=None)``: eval returns
    the showers; ``train`` returns ``(showers, new statistics)`` (empty but
    under ``"batch"``), with the five keep masks ``keep`` (``None``: no
    dropout) and the routing ``mask`` ``[B]`` of the batch statistics."""

    train_form = True
    rate = DROPOUT_RATE

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
        self.norm_names = _norm_layers(self, norm, ((256, False), (self.c0 * 13 * 13, False),
                                                    (w(256), True), (w(128), True),
                                                    (w(64), True)))
        self.dropout_shapes = ((256,), (self.c0 * 13 * 13,), (24, 24, w(256)),
                               (46, 46, w(128)), (45, 45, w(64)))

    def forward(self, noise: torch.Tensor, cond: torch.Tensor, train: bool = False,
                keep: Optional[Sequence[torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None):
        new: Stats = {}

        def block(i, x):
            x = self._norm(i, x, train, mask, new)
            if keep is not None:
                x = dropout(x, _nchw(keep[i]), self.rate)
            return leaky_relu(x)

        x = torch.cat([noise, cond], dim=1)
        x = block(0, self.Dense_0(x))
        x = block(1, self.Dense_1(x))
        # the Dense output is laid out (13, 13, C) in HWC order
        x = x.reshape(-1, 13, 13, self.c0).permute(0, 3, 1, 2)
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 26x26
        x = block(2, self.Conv_0(x))  # 24x24
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 48x48
        x = block(3, self.Conv_1(x))  # 46x46
        x = block(4, self.Conv_2(x))  # 45x45
        out = torch.relu(self.Conv_3(x)).permute(0, 2, 3, 1)  # 44x44
        return (out, new) if train else out


class GeneratorNeutronV2(nn.Module):
    """The proton recipe on the neutron geometry (``zdcsim/models/neutron.py:117``):
    MLPBlock 256 -> MLPBlock w(512)*12*12 -> 12x12 -> up x2 -> Conv4x4 w(256)
    pad 1 (23x23) -> nearest resize to 44x44 -> Conv4x4 w(128) pad 1 (43x43)
    -> Conv3x3 w(64) pad 1 -> Conv2x2 1 pad 1 (44x44) -> ReLU; GroupNorm2d +
    LeakyReLU(0.1) after each of the first three convs (``norm="group"``),
    or LeakyReLU alone (``"none"``). It has no dropout and no batch
    statistics: its training forward is its eval forward (``train`` is
    accepted and changes nothing)."""

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
        x = torch.cat([noise, cond], dim=1)
        x = self.MLPBlock_1(self.MLPBlock_0(x))
        x = x.reshape(-1, 12, 12, self.c0).permute(0, 3, 1, 2)
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # 24x24
        x = self._norm_leaky(0, self.Conv_0(x))  # 23x23
        # nearest-exact 23 -> 44, index tensors made on the device; the
        # backward by gathers, reproducible on CUDA (``gather_nearest``)
        rows = nearest_index_on(NEUTRON_SHAPE[0], x.shape[2], x.device)
        cols = nearest_index_on(NEUTRON_SHAPE[1], x.shape[3], x.device)
        x = gather_nearest(gather_nearest(x, 2, rows), 3, cols)
        x = self._norm_leaky(1, self.Conv_1(x))  # 43x43
        x = self._norm_leaky(2, self.Conv_2(x))  # 43x43
        return torch.relu(self.Conv_3(x)).permute(0, 2, 3, 1)  # 44x44


class DiscriminatorNeutron(Discriminator):
    """Hinge discriminator with spectral norm for 44x44 showers
    (``zdcsim/models/neutron.py:184``): the proton ``Discriminator`` with the
    second pool at (2, 2), so the flat size is 16 * 9 * 9 = 1296, then the
    conditions."""

    def __init__(self, cond_dim: int = 9, image_shape: Tuple[int, int] = NEUTRON_SHAPE):
        super().__init__(cond_dim=cond_dim, image_shape=image_shape, pool_1=(2, 2))


class AuxRegNeutron(_Normed):
    """(max_x, max_y) regressor for neutron showers (``zdcsim/models/neutron.py:223``):
    four stages of VALID Conv3x3 (32, 64, 128, 256) -> norm -> LeakyReLU(0.1)
    -> ``Dropout(0.2)`` -> max pool (2, 2), (2, 1), (2, 1), none (44 -> 42 ->
    21 -> 19 -> 9x19 -> 7x17 -> 3x17 -> 1x15), then a bias-free 1x1 conv to
    64 -> norm -> LeakyReLU -> mean over H and W -> Dense 2. The norms:
    ``MaskedBatchNorm_0..4`` (``"batch"``), ``GroupNorm2d_0..4``
    (``"group"``) or none.

    ``forward(img, keep=None, train=False, mask=None)``: ``keep`` holds the
    four keep masks (shapes in :attr:`dropout_shapes`; ``None``: no
    dropout); eval returns ``[B, 2]``, ``train`` returns ``([B, 2], new
    statistics)``."""

    train_form = True
    rate = DROPOUT_RATE
    dropout_shapes = ((42, 42, 32), (19, 19, 64), (7, 17, 128), (1, 15, 256))
    _POOLS = ((2, 2), (2, 1), (2, 1), None)

    def __init__(self, output_dim: int = 2, norm: str = "batch"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        chans = (1, 32, 64, 128, 256)
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 3))
        self.Conv_4 = nn.Conv2d(256, 64, 1, bias=False)
        self.norm_names = _norm_layers(self, norm, [(c, True) for c in (*chans[1:], 64)])
        self.Dense_0 = nn.Linear(64, output_dim)

    def forward(self, img: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False, mask: Optional[torch.Tensor] = None):
        new: Stats = {}
        if img.ndim == 3:
            img = img[..., None]
        x = img.permute(0, 3, 1, 2)
        for i, pool in enumerate(self._POOLS):
            x = leaky_relu(self._norm(i, getattr(self, f"Conv_{i}")(x), train, mask, new))
            if keep is not None:
                x = dropout(x, _nchw(keep[i]), self.rate)
            if pool is not None:
                x = max_pool(x, pool)
        x = leaky_relu(self._norm(4, self.Conv_4(x), train, mask, new))
        out = self.Dense_0(x.mean(dim=(2, 3)))
        return (out, new) if train else out
