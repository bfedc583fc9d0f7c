"""Collectives of the train step on a ``(data, expert)`` mesh, with their
backward passes.

JAX's GSPMD step computes every loss over the global batch and lets its
partitioner insert the reductions. Here a rank computes its rows (and, on
the dense step, its experts) and the collectives are explicit:

- :func:`all_gather` joins a per-row (or per-expert) quantity of every rank
  of a mesh axis into the global tensor. Every rank then computes the same
  loss from the same global tensor, so the loss is *replicated*: its
  gradient with respect to the global tensor is the same on every rank, and
  a rank's share of it is its own slice. The backward pass therefore takes
  the slice and sends nothing (``torch.distributed.nn``'s all-gather sums
  the gradients over the ranks instead, which is right for a loss that
  differs on each rank and ``world`` times too large for a replicated one).
- :func:`psum` sums a tensor over a mesh axis; its backward sums the
  gradient over the same axis (each rank's replicated loss reaches the sum
  through that rank's rows only). ``MaskedBatchNorm`` takes its statistics
  through it (:func:`masked_moments`).
- :func:`psum_` sums gradients in place, outside autograd: the data
  ranks' shares of a parameter gradient.

Every function is collective: each rank of the axis calls it, in the same
order, with a tensor of the same shape. A mesh axis of one rank makes each
of them the identity, op for op, so a world of one computes what the
meshless step computes, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from zdcsim_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, Mesh, _dist

WORLD = "world"  # both mesh axes: every rank, in grid order (data-major)


def axis_group(mesh: Mesh, axis: str) -> Tuple[object, int, int]:
    """``(process group, its size, this rank's index in it)`` of a mesh axis
    (``"data"``, ``"expert"`` or ``"world"``: the default group, whose rank
    order is the grid's, data coordinate first)."""
    if axis == WORLD:
        return None, int(mesh.devices.size), int(mesh.rank)
    d, e = mesh.coords
    if axis == DATA_AXIS:
        return mesh.data_group, mesh.shape[DATA_AXIS], d
    if axis == EXPERT_AXIS:
        return mesh.expert_group, mesh.shape[EXPERT_AXIS], e
    raise ValueError(f"no mesh axis {axis!r}: data, expert or world")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.n, ctx.index, ctx.dim, ctx.size = n, index, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        _dist().all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        _dist().all_reduce(out, group=ctx.group)
        return out, None


def all_gather(mesh: Optional[Mesh], axis: str, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each rank's ``x`` along ``axis``, concatenated on ``dim`` in the axis's
    rank order; the backward pass keeps this rank's slice (the module doc).
    ``mesh=None`` or an axis of one rank: ``x`` itself."""
    if mesh is None:
        return x
    group, n, index = axis_group(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, group, n, index, dim)


def psum(mesh: Optional[Mesh], axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``axis``; the backward pass sums the gradient over it.
    ``mesh=None`` or an axis of one rank: ``x`` itself."""
    if mesh is None:
        return x
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return x
    return _Psum.apply(x, group)


def psum_(mesh: Optional[Mesh], axis: str, tensors) -> None:
    """Sum each tensor of ``tensors`` over ``axis`` in place, outside
    autograd (one all-reduce a tensor, in the given order)."""
    if mesh is None:
        return
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return
    for t in tensors:
        _dist().all_reduce(t, group=group)


def shard_rows(mesh: Optional[Mesh], axis: str, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, split over ``axis`` (the
    inverse of :func:`all_gather`; a view). Raises ``ValueError`` where the
    axis does not divide the dim."""
    if mesh is None:
        return x
    _, n, index = axis_group(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"the {axis!r} mesh axis of {n} ranks does not divide the "
                         f"{x.shape[dim]} rows of a tensor of shape {tuple(x.shape)}")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


def masked_moments(x: torch.Tensor, m: Optional[torch.Tensor], axes, sum_rows=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, biased var, centered x)`` over ``axes`` of ``x`` with each
    row weighted by ``m`` (broadcast against ``x``; ``None``: every row), in
    two passes as JAX computes them: the global mean first, then the global
    sum of squared deviations from it (never ``E[x^2] - E[x]^2``). A rank's
    partial sums and its count go through ``sum_rows`` (``psum`` over the
    data axis on a mesh; ``None``: this rank's rows are the batch); the
    count is ``max(sum(m) * elements a row, 1)``."""
    sum_rows = sum_rows or (lambda t: t)
    per_row = 1.0
    for a in axes[1:]:
        per_row *= x.shape[a]
    feat = [1] * x.ndim
    feat[1] = -1
    if m is None:
        s1 = x.sum(axes)
        w_sum = torch.full((), float(x.shape[0]), dtype=x.dtype, device=x.device)
    else:
        s1, w_sum = (x * m).sum(axes), m.sum()
    s1, w_sum = sum_rows(s1), sum_rows(w_sum)
    cnt = torch.clamp(w_sum * per_row, min=1.0)
    mean = s1 / cnt
    centered = x - mean.reshape(feat)
    sq = centered * centered
    var = sum_rows((sq if m is None else sq * m).sum(axes)) / cnt
    return mean, var, centered
