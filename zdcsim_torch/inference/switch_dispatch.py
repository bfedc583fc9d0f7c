"""Tiled-switch MoE dispatch (counterpart of
``zdcsim/inference/switch_dispatch.py``): :func:`tiled_switch_decode` for
serving (``:35``), :func:`tiled_switch_apply` for training (``:149``).

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

:func:`tiled_switch_apply` is the training form: pytrees of ``[B, ...]``
inputs and outputs, differentiable, per-expert closures only, pad lanes
writing to the dummy row (each real row is written once), and one
out-of-place scatter of every chunk's outputs.

``tiled_switch_decode.lanes`` counts the lanes decoded, pad lanes
included: ``T`` for each used chunk of the per-expert form, ``T`` for each
of the ``K`` chunks of the ``decode_dyn`` form. Its spans
(``zdcsim_torch.utils.profiling.span``, recorded only under a profiler):
``serve.table``, the chunk table with its host read, and ``serve.decode``,
each chunk's decode call (its gathers and its scatter lie outside).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from zdcsim_torch.utils.profiling import span


def _chunk_table(idx: torch.Tensor, e_count: int, tile: int, on_host_counts: bool):
    """The aligned chunks of ``idx`` [B]: ``(rows [K, T], e_k [K], used [K],
    real [K, T])``. ``rows`` are the source rows of each lane (a pad lane
    repeats its segment's last real sample, clamped into ``[0, B)`` where
    the expert has none); ``used`` marks the chunks inside the aligned
    layout of an expert with samples; ``real`` the lanes of real samples.
    ``on_host_counts``: count with ``torch.bincount`` (which reads its
    maximum to the host on CUDA) instead of a comparison sum."""
    b = idx.shape[0]
    if b % tile != 0:
        raise ValueError(f"batch {b} must be a multiple of tile {tile}")
    dev = idx.device
    k_chunks = b // tile + e_count  # upper bound on the aligned chunks

    if on_host_counts:
        counts = torch.bincount(idx, minlength=e_count)
    else:
        counts = (idx[:, None] == torch.arange(e_count, device=dev)[None, :]).sum(0)
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
    n_e = counts[e_k][:, None]
    src = seg_start[e_k][:, None] + torch.minimum(local, torch.clamp(n_e - 1, min=0))
    rows = perm[torch.clamp(src, max=b - 1)]
    used = (pos < aligned_off[-1]) & (counts[e_k] > 0)
    return rows, e_k, used, local < n_e


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
    b = idx.shape[0]
    with span("serve.table"):
        rows, e_k, used, _ = _chunk_table(idx, len(decode_fns), tile, decode_dyn is None)
        rows = torch.where(used[:, None], rows, torch.full_like(rows, b))
        todo = (range(rows.shape[0]) if decode_dyn is not None
                else [k for k, u in enumerate(used.tolist()) if u])
        experts = None if decode_dyn is not None else e_k.tolist()
    tiled_switch_decode.lanes += tile * len(todo)

    out = None
    # the dyn form decodes every chunk; an unused one decodes row b - 1 into
    # the dummy row b
    read = rows if decode_dyn is None else torch.clamp(rows, max=b - 1)
    for k in todo:
        z, c = noise[read[k]], cond[read[k]]
        with span("serve.decode"):
            img = (decode_fns[experts[k]](z, c) if decode_dyn is None
                   else decode_dyn(e_k[k], z, c))
        if out is None:
            out = img.new_zeros((b + 1, *out_shape))
        out.index_copy_(0, rows[k], img)
    return out[:b]


tiled_switch_decode.lanes = 0


Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def tiled_switch_apply(
    apply_fns: Sequence[Callable[[Dict[str, torch.Tensor]], Outputs]],
    idx: torch.Tensor,
    inputs: Dict[str, torch.Tensor],
    tile: int = 64,
    remat: bool = False,
) -> Outputs:
    """Each sample through its routed expert, differentiably (the training
    form of :func:`tiled_switch_decode`).

    apply_fns: per-expert closures from a chunk ``{name: [T, ...]}`` to a
    ``[T, ...]`` tensor or a tuple of them; idx: ``[B]`` expert of each
    sample (not differentiated); inputs: ``{name: [B, ...]}``, gathered per
    chunk; tile must divide B. ``remat``: each chunk's forward runs under
    ``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
    backward pass (JAX's ``jax.checkpoint(run_chunk)``). Returns the
    outputs as ``[B, ...]`` in the closures' structure.

    A pad lane (a replica of its segment's last real sample) writes to the
    dummy row ``B``, so each real row is written once and its cotangent
    reaches its one chunk lane: a duplicate write would count a boundary
    sample's cotangent twice (the divergence JAX documents at ``:165``).
    All chunks' outputs go back in one out-of-place scatter per output.
    JAX runs every one of the ``B/T + E`` chunks; here the chunk table is
    read to the host once a call and the unused chunks, which reach only
    the dummy row, are skipped.
    """
    b = idx.shape[0]
    rows, e_k, used, real = _chunk_table(idx, len(apply_fns), tile, True)
    rows_out = torch.where(used[:, None] & real, rows, torch.full_like(rows, b))
    run = [k for k, u in enumerate(used.tolist()) if u]
    experts = e_k.tolist()
    if remat:
        from torch.utils.checkpoint import checkpoint
    outs = []
    for k in run:
        chunk = {name: x.index_select(0, rows[k]) for name, x in inputs.items()}
        fn = apply_fns[experts[k]]
        outs.append(checkpoint(fn, chunk, use_reentrant=False, preserve_rng_state=False)
                    if remat else fn(chunk))
    flat_rows = rows_out[run].reshape(-1)

    def scatter(parts):
        src = torch.cat(parts)
        return src.new_zeros((b + 1, *src.shape[1:])).index_copy(0, flat_rows, src)[:b]

    if isinstance(outs[0], torch.Tensor):
        return scatter(outs)
    return tuple(scatter(list(parts)) for parts in zip(*outs))
