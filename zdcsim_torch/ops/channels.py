"""5-channel ZDC photomultiplier decomposition (counterpart of
``zdcsim/ops/channels.py``).

The readout has 5 towers: 4 spatial-quadrant checkerboard masks plus the
complementary checkerboard. The masks here are bit-identical to the JAX
package's; the channel sums are one ``[N, H*W] @ [H*W, 5]`` matmul against
the constant basis. Kernel E (``zdcsim_torch.ops.epilogue_kernels``) fuses
``expm1`` with these sums on the card.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def get_channel_masks(shape: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
    """The 5 float32 channel masks of an ``(H, W)`` image.

    mask1..mask4: the checkerboard ``(row + col)`` odd limited to the
    lower-left / lower-right / upper-left / upper-right quadrant ("lower" is
    ``row >= H // 2``, "left" is ``col < W // 2``); mask5: the complementary
    checkerboard over the whole image. Every pixel is in exactly one mask.
    """
    h, w = shape
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    checker = ((rows + cols) % 2 == 1).astype(np.float32)
    mask5 = 1.0 - checker
    lower = rows >= h // 2
    left = cols < w // 2
    quads = (lower & left, lower & ~left, ~lower & left, ~lower & ~left)
    return tuple((checker * q).astype(np.float32) for q in quads) + (mask5.astype(np.float32),)


@functools.lru_cache(maxsize=None)
def channel_basis(shape: Tuple[int, int]) -> np.ndarray:
    """Constant ``[H*W, 5]`` matrix whose columns are the flattened masks."""
    return np.stack([m.reshape(-1) for m in get_channel_masks(tuple(shape))], axis=1)


def sum_channels(images: torch.Tensor, already_expm1: bool = True) -> torch.Tensor:
    """Per-image 5-channel sums ``[N, 5]`` of ``[N, H, W]`` (or ``[N, 1, H, W]``)
    images, in linear space unless ``already_expm1=False`` (then log-space,
    and ``expm1`` is applied first). Computed in the images' dtype on their
    device."""
    if images.ndim == 4:
        images = images.reshape(images.shape[0], *images.shape[-2:])
    n, h, w = images.shape
    basis = torch.as_tensor(channel_basis((h, w)), dtype=images.dtype, device=images.device)
    flat = images.reshape(n, h * w)
    if not already_expm1:
        flat = torch.expm1(flat)
    return flat @ basis


def sum_channels_np(images: np.ndarray) -> np.ndarray:
    """Host-side numpy version (linear-space input)."""
    images = np.asarray(images)
    if images.ndim == 4:
        images = images.reshape(images.shape[0], *images.shape[-2:])
    n, h, w = images.shape
    return images.reshape(n, h * w) @ channel_basis((h, w))
