"""Carry weights across from the JAX package's Flax trees.

Two layouts meet here:

- the **Flax layout**: nested dicts keyed by module names, Dense kernels
  ``[in, out]``, conv kernels HWIO, norm ``scale``; generator experts stacked
  on a leading ``[E, ...]`` axis. ``proton_fast`` and the engine consume the
  generator in this layout (as tensors), so tests compare like with like;
- the **PyTorch layout** of the port's ``nn.Module``s, whose submodules carry
  the Flax names: ``Linear.weight [out, in]``, ``Conv2d.weight`` OIHW, norm
  ``weight``; a BatchNorm's ``batch_stats`` ``mean``/``var`` are its
  ``running_mean``/``running_var`` buffers; a module's own parameter (the
  attention router's ``expert_queries``) and a kernel of three axes
  (``ExpertDense``'s ``[E, I, O]``) keep their names and layouts.

The mapping is by name and is lossless both ways.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
# parameters declared by a module itself (``self.param``), kept as they are:
# the attention router's ``[E, embed_dim]`` queries
_OWN_PARAMS = ("expert_queries",)


def _join(path: str, leaf: str, sep: str) -> str:
    return f"{path}{sep}{leaf}" if path else leaf


def _kernel_to_torch(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``[in, out]`` -> ``[out, in]``, HWIO -> OIHW, after ``lead`` stacked axes."""
    keep = tuple(range(lead))
    if t.ndim - lead == 2:
        return t.transpose(-1, -2)
    return t.permute(*keep, lead + 3, lead + 2, lead, lead + 1)


def _kernel_to_flax(t: torch.Tensor, lead: int) -> torch.Tensor:
    """Inverse of :func:`_kernel_to_torch`."""
    keep = tuple(range(lead))
    if t.ndim - lead == 2:
        return t.transpose(-1, -2)
    return t.permute(*keep, lead + 2, lead + 3, lead + 1, lead)


def to_state_dict(tree: Dict[str, Any], stats: Optional[Dict[str, Any]] = None,
                  stacked: bool = False) -> Dict[str, torch.Tensor]:
    """One module's Flax tree (numpy or tensors) -> ``state_dict``; ``stats``
    is its ``batch_stats`` collection (``{MaskedBatchNorm_i: {mean, var}}``),
    if it has one. ``stacked``: every leaf has a leading expert axis, which
    stays in front."""
    lead = int(stacked)
    sd = {}
    for key, v in _flatten(tree).items():
        path, _, leaf = key.rpartition(_SEP)
        t = torch.as_tensor(v)
        if leaf == "kernel" and t.ndim - lead == 3:  # ExpertDense's [E, I, O], kept
            pass
        elif leaf == "kernel":
            t = _kernel_to_torch(t, lead)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", *_OWN_PARAMS):
            raise ValueError(f"unexpected Flax leaf {key!r}")
        sd[_join(path.replace(_SEP, "."), leaf, ".")] = t.contiguous()
    for key, v in _flatten(stats or {}).items():
        path, _, leaf = key.rpartition(_SEP)
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"unexpected batch_stats leaf {key!r}")
        sd[f"{path.replace(_SEP, '.')}.{_STAT_LEAVES[leaf]}"] = torch.as_tensor(v).contiguous()
    return sd


def _flax_leaf(key: str, t: torch.Tensor, lead: int) -> Tuple[str, torch.Tensor, bool]:
    """One ``state_dict`` entry -> ``(flat Flax key, tensor in Flax layout,
    is a BatchNorm statistic)``."""
    path, _, leaf = key.rpartition(".")
    stat = leaf in _STAT_LEAVES.values()
    if leaf in _OWN_PARAMS or leaf == "kernel":
        pass
    elif leaf == "weight":
        if t.ndim - lead == 1:
            leaf = "scale"
        else:
            t = _kernel_to_flax(t, lead)
            leaf = "kernel"
    elif stat:
        leaf = {v: k for k, v in _STAT_LEAVES.items()}[leaf]
    return _join(path.replace(".", _SEP), leaf, _SEP), t, stat


def from_state_dict(sd: Dict[str, torch.Tensor], stats_out: Optional[Dict[str, Any]] = None,
                    stacked: bool = False) -> Dict[str, Any]:
    """Inverse of :func:`to_state_dict`, to numpy. The running statistics of
    a BatchNorm go into ``stats_out`` (the ``batch_stats`` collection); a
    state dict that holds them and no ``stats_out`` raises, so nothing is
    dropped."""
    flat, stats = {}, {}
    for key, t in sd.items():
        name, t, stat = _flax_leaf(key, t.detach().cpu(), int(stacked))
        (stats if stat else flat)[name] = t.contiguous().numpy()
    if stats:
        if stats_out is None:
            raise ValueError("the state dict holds BatchNorm running statistics: pass stats_out")
        stats_out.update(_unflatten(stats))
    return _unflatten(flat)


def flax_view(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """One module's parameters (a ``state_dict`` without statistics, one
    expert) as the nested Flax-layout tree of :func:`from_state_dict`, on
    the same device, as views: differentiable, so a training forward that
    reads the Flax layout (``proton_fast``) reaches the parameters."""
    flat = {}
    for key, t in params.items():
        name, t, stat = _flax_leaf(key, t, 0)
        if stat:
            raise ValueError(f"flax_view takes parameters only, got {key!r}")
        flat[name] = t
    return _unflatten(flat)


def from_jax_params(gen_params: Any, router_params: Any) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Numpy Flax trees (``load_serving_artifact``) -> the port's tensors.

    Returns ``(gen, router)``: ``gen`` is the generator tree as float32 CPU
    tensors in the Flax layout, experts stacked on the leading axis;
    ``router`` is the ``state_dict`` of the router
    (``zdcsim_torch.models.router``).
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


# ---------------------------------------------------------------------------
# The train state (zdcsim/train/state.py MoETrainState <-> zdcsim_torch's)
# ---------------------------------------------------------------------------

_COMPONENTS = ("gen", "disc", "aux", "router")


def _field(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _train_stats_from_jax(stats: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """``{"batch_stats": nested}`` (or ``{}``) -> the flat stats tree keyed by
    ``|``-joined paths (Flax's own keys keep their ``/``)."""
    if set(stats) - {"batch_stats"}:
        raise ValueError(f"unexpected collections {sorted(stats)}")
    return {k: torch.as_tensor(np.array(v, dtype=np.float32)).to(device)
            for k, v in _flatten(stats.get("batch_stats", {})).items()}


def train_state_from_jax(state: Any, device: str | torch.device | None = None):
    """A JAX ``MoETrainState`` (``zdcsim/train/state.py``, arrays or numpy)
    or the dict form :func:`train_state_to_jax` returns -> the port's
    ``MoETrainState`` on ``device`` (CUDA unless the caller asks for the
    CPU). Parameters, Adam ``mu``/``nu`` and the EMA go to the PyTorch
    layout, experts stacked in front (the router is not stacked); the
    discriminator's spectral-norm ``u``/``sigma`` keep Flax's paths; Adam's
    ``count`` and ``step`` stay int32 scalars. Optax's state is read as
    ``(ScaleByAdamState(count, mu, nu), ...)``."""
    from zdcsim_torch.device import default_device
    from zdcsim_torch.train.state import AdamState, Component, MoETrainState

    dev = default_device(device)

    def params(tree, stacked):
        np_tree = _unflatten({k: np.array(v, dtype=np.float32)
                              for k, v in _flatten(tree).items()})
        return {k: v.to(dev) for k, v in to_state_dict(np_tree, stacked=stacked).items()}

    def scalar(x):
        return torch.as_tensor(np.array(x, dtype=np.int32)).to(dev)

    def component(c, stacked):
        opt = _field(c, "opt_state")
        adam = opt if isinstance(opt, Mapping) else opt[0]
        return Component(
            params=params(_field(c, "params"), stacked),
            stats=_train_stats_from_jax(dict(_field(c, "stats")), dev),
            opt_state=AdamState(count=scalar(_field(adam, "count")),
                                mu=params(_field(adam, "mu"), stacked),
                                nu=params(_field(adam, "nu"), stacked)))

    comps = {n: component(_field(state, n), n != "router") for n in _COMPONENTS}
    return MoETrainState(**comps, ema_gen_params=params(_field(state, "ema_gen_params"), True),
                         step=scalar(_field(state, "step")))


def train_state_to_jax(state) -> Dict[str, Any]:
    """Inverse of :func:`train_state_from_jax`, to numpy: ``{"gen": {"params",
    "stats", "opt_state": {"count", "mu", "nu"}}, "disc": ..., "aux": ...,
    "router": ..., "ema_gen_params", "step"}`` in the Flax layout, stats as
    ``{"batch_stats": nested}`` or ``{}``. A JAX state is
    ``MoETrainState(gen=Component(params, stats, (ScaleByAdamState(count, mu,
    nu), EmptyState())), ...)`` of these leaves."""

    def component(c, stacked):
        flat = {k: v.detach().cpu().numpy() for k, v in c.stats.items()}
        return {"params": from_state_dict(c.params, stacked=stacked),
                "stats": {"batch_stats": _unflatten(flat)} if flat else {},
                "opt_state": {"count": c.opt_state.count.cpu().numpy(),
                              "mu": from_state_dict(c.opt_state.mu, stacked=stacked),
                              "nu": from_state_dict(c.opt_state.nu, stacked=stacked)}}

    out = {n: component(getattr(state, n), n != "router") for n in _COMPONENTS}
    out["ema_gen_params"] = from_state_dict(state.ema_gen_params, stacked=True)
    out["step"] = state.step.cpu().numpy()
    return out
