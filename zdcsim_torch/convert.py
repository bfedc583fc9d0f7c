"""Carry weights across from the JAX package's Flax trees.

Two layouts meet here:

- the **Flax layout**: nested dicts keyed by module names, Dense kernels
  ``[in, out]``, conv kernels HWIO, norm ``scale``; generator experts stacked
  on a leading ``[E, ...]`` axis. ``proton_fast`` and the engine consume the
  generator in this layout (as tensors), so tests compare like with like;
- the **PyTorch layout** of the port's ``nn.Module``s, whose submodules carry
  the Flax names: ``Linear.weight [out, in]``, ``Conv2d.weight`` OIHW, norm
  ``weight``; a BatchNorm's ``batch_stats`` ``mean``/``var`` are its
  ``running_mean``/``running_var`` buffers.

The mapping is by name and is lossless both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from zdcsim_torch.utils.artifact import _flatten, _unflatten

_SEP = "|"


def tree_to_torch(tree: Any, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cpu") -> Dict[str, Any]:
    """Nested dict of arrays -> the same nested dict of tensors."""
    flat = {
        k: torch.as_tensor(v).to(device=device, dtype=dtype)
        for k, v in _flatten(tree).items()
    }
    return _unflatten(flat)


def expert(tree: Dict[str, Any], e: int) -> Dict[str, Any]:
    """Expert ``e``'s slice of a tree stacked on a leading axis."""
    return _unflatten({k: v[e] for k, v in _flatten(tree).items()})


_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def to_state_dict(tree: Dict[str, Any], stats: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, torch.Tensor]:
    """One module's Flax tree (numpy or tensors) -> ``state_dict``; ``stats``
    is its ``batch_stats`` collection (``{MaskedBatchNorm_i: {mean, var}}``),
    if it has one."""
    sd = {}
    for key, v in _flatten(tree).items():
        path, _, leaf = key.rpartition(_SEP)
        t = torch.as_tensor(v)
        if leaf == "kernel":
            t = t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)  # [in,out] / HWIO
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected Flax leaf {key!r}")
        sd[f"{path.replace(_SEP, '.')}.{leaf}"] = t.contiguous()
    for key, v in _flatten(stats or {}).items():
        path, _, leaf = key.rpartition(_SEP)
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"unexpected batch_stats leaf {key!r}")
        sd[f"{path.replace(_SEP, '.')}.{_STAT_LEAVES[leaf]}"] = torch.as_tensor(v).contiguous()
    return sd


def from_state_dict(sd: Dict[str, torch.Tensor], stats_out: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Inverse of :func:`to_state_dict`, to numpy. The running statistics of
    a BatchNorm go into ``stats_out`` (the ``batch_stats`` collection); a
    state dict that holds them and no ``stats_out`` raises, so nothing is
    dropped."""
    flat, stats = {}, {}
    for key, t in sd.items():
        path, _, leaf = key.rpartition(".")
        t = t.detach().cpu()
        into = flat
        if leaf == "weight":
            if t.ndim == 1:
                leaf = "scale"
            else:
                t = t.T if t.ndim == 2 else t.permute(2, 3, 1, 0)  # -> [in,out] / HWIO
                leaf = "kernel"
        elif leaf in _STAT_LEAVES.values():
            leaf = {v: k for k, v in _STAT_LEAVES.items()}[leaf]
            into = stats
        into[f"{path.replace('.', _SEP)}{_SEP}{leaf}"] = t.contiguous().numpy()
    if stats:
        if stats_out is None:
            raise ValueError("the state dict holds BatchNorm running statistics: pass stats_out")
        stats_out.update(_unflatten(stats))
    return _unflatten(flat)


def from_jax_params(gen_params: Any, router_params: Any) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Numpy Flax trees (``load_serving_artifact``) -> the port's tensors.

    Returns ``(gen, router)``: ``gen`` is the generator tree as float32 CPU
    tensors in the Flax layout, experts stacked on the leading axis;
    ``router`` is the ``state_dict`` of
    :class:`zdcsim_torch.models.router.RouterNetwork`.
    """
    return tree_to_torch(gen_params), to_state_dict(router_params)


def to_jax_params(gen: Dict[str, Any], router: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`from_jax_params`, to numpy Flax trees."""
    gen_np = _unflatten({k: v.detach().cpu().numpy() for k, v in _flatten(gen).items()})
    return gen_np, from_state_dict(router)


def stats_from_jax(gen_stats: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The generator's ``gen_stats`` as ``load_serving_artifact`` returns it
    (``{"batch_stats": {MaskedBatchNorm_i: {mean, var}}}``, experts stacked
    on the leading axis, or empty) -> its ``batch_stats`` collection as
    float32 CPU tensors (``{}`` when there is none)."""
    gen_stats = gen_stats or {}
    if set(gen_stats) - {"batch_stats"}:
        raise ValueError(f"unexpected generator collections {sorted(gen_stats)}")
    return tree_to_torch(gen_stats.get("batch_stats", {}))


def stats_to_jax(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`stats_from_jax`, to numpy."""
    flat = {k: v.detach().cpu().numpy() for k, v in _flatten(stats).items()}
    return {"batch_stats": _unflatten(flat)} if flat else {}
