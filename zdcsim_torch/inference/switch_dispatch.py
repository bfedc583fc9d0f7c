"""Tiled-switch MoE dispatch (counterpart of
``zdcsim/inference/switch_dispatch.py:35``).

Each sample is decoded by its routed expert only:

1. stable-sort the samples by expert, so each expert's samples are
   contiguous;
2. align each expert's segment up to a multiple of the tile ``T``; the pad
   lanes replicate the segment's last real sample (same expert, same noise:
   same output);
3. walk the ``K = B/T + E`` aligned chunks. Each used chunk belongs to one
   expert and decodes its ``T`` samples with that expert's decoder;
4. scatter each chunk's output into a ``[B + 1, *out]`` buffer in place
   (JAX's ``in_scan_scatter=True``, the JAX engine's default, so the port
   has no such argument). Row ``B`` is the dummy row of unused lanes.

JAX runs step 3 as a ``lax.scan`` with static shapes. Here the chunk loop
is Python, in one of two forms:

- with per-expert decoders (the port's ``lax.switch``): one host read of
  the chunk table per batch, and unused chunks are skipped;
- with ``decode_dyn`` (JAX's ``dyn_dispatch``): every one of the K chunks
  is decoded through one branchless decoder that takes the chunk's expert
  as a device tensor, unused chunks on row ``B - 1`` writing to the dummy
  row. Nothing is read to the host, so the launch sequence is fixed per
  ``(B, T)`` and a CUDA graph can hold it. ``torch.bincount`` reads its
  maximum to the host on CUDA, so this form counts by a comparison sum.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def tiled_switch_decode(
    decode_fns: Sequence[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
    idx: torch.Tensor,
    cond: torch.Tensor,
    noise: torch.Tensor,
    out_shape: Tuple[int, ...],
    tile: int = 128,
    decode_dyn: Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Decode each sample with its routed expert.

    decode_fns: per-expert ``(noise [T, Z], cond [T, C]) -> [T, *out_shape]``;
    idx: ``[B]`` expert of each sample; cond ``[B, C]``; noise ``[B, Z]``;
    tile must divide B. decode_dyn: optional branchless ``(e_k, noise,
    cond) -> [T, *out_shape]`` with ``e_k`` the chunk's expert as a 0-d
    device tensor; it must decode as ``decode_fns[e_k]`` does, which still
    give the expert count. Returns ``[B, *out_shape]``.
    """
    e_count = len(decode_fns)
    b = idx.shape[0]
    if b % tile != 0:
        raise ValueError(f"batch {b} must be a multiple of tile {tile}")
    dev = idx.device
    k_chunks = b // tile + e_count  # upper bound on the aligned chunks

    experts = torch.arange(e_count, device=dev)
    if decode_dyn is None:
        counts = torch.bincount(idx, minlength=e_count)
    else:
        counts = (idx[:, None] == experts[None, :]).sum(0)
    padded = (counts + tile - 1) // tile * tile
    zero = torch.zeros(1, dtype=counts.dtype, device=dev)
    aligned_off = torch.cat([zero, torch.cumsum(padded, 0)])
    seg_start = torch.cat([zero, torch.cumsum(counts, 0)])
    perm = torch.argsort(idx, stable=True)

    pos = torch.arange(k_chunks, device=dev) * tile
    e_k = torch.clamp(
        torch.searchsorted(aligned_off[1:], pos, right=True), 0, e_count - 1
    )
    lane = torch.arange(tile, device=dev)
    local = (pos - aligned_off[e_k])[:, None] + lane[None, :]
    last = torch.clamp(counts[e_k] - 1, min=0)[:, None]
    src = seg_start[e_k][:, None] + torch.minimum(local, last)
    rows = perm[torch.clamp(src, max=b - 1)]
    used = (pos < aligned_off[-1]) & (counts[e_k] > 0)
    rows = torch.where(used[:, None], rows, torch.full_like(rows, b))

    out = None
    if decode_dyn is not None:
        # every chunk; an unused one decodes row b - 1 into the dummy row b
        read = torch.clamp(rows, max=b - 1)
        for k in range(k_chunks):
            img = decode_dyn(e_k[k], noise[read[k]], cond[read[k]])
            if out is None:
                out = img.new_zeros((b + 1, *out_shape))
            out.index_copy_(0, rows[k], img)
        return out[:b]
    for k, (u, e) in enumerate(zip(used.tolist(), e_k.tolist())):
        if not u:
            continue
        r = rows[k]
        img = decode_fns[e](noise[r], cond[r])
        if out is None:
            out = img.new_zeros((b + 1, *out_shape))
        out.index_copy_(0, r, img)
    return out[:b]
