"""The ``(data, expert)`` mesh of ``torch.distributed`` ranks and its
placement rules (counterpart of ``zdcsim/parallel/mesh.py``).

A mesh is the world's ranks laid out as a ``(n // expert_parallel,
expert_parallel)`` grid (:func:`mesh_grid`, a pure function), with one
process group along each axis through each rank. Where JAX places an array
with a ``NamedSharding``, a :class:`Placement` here gives a rank its local
piece:

- ``batch_sharding``: a rank's rows of the leading axis, by its data
  coordinate;
- ``replicated``: the whole tensor on every rank, broadcast from rank 0;
- the expert rule (:func:`state_shardings`): an expert-stacked ``[E, ...]``
  leaf's rows by the rank's expert coordinate.

Every function that runs a collective (:func:`make_mesh`, a replicated
placement, :func:`shard_state`, :func:`gather_state`) must be called by
every rank, in the same order. Rank r runs on ``cuda:{LOCAL_RANK}`` (NCCL)
unless the caller asks for the CPU (gloo), as the tests do; a mesh never
falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


def _dist():
    import torch.distributed as dist

    return dist


def mesh_grid(n_devices: int, expert_parallel: int = 1) -> np.ndarray:
    """The ranks ``0 .. n_devices - 1`` as a ``(n_devices // expert_parallel,
    expert_parallel)`` grid: rank ``d * expert_parallel + e`` at data
    coordinate ``d`` and expert coordinate ``e`` (JAX's reshape of its device
    list). Raises ``ValueError`` where ``expert_parallel`` does not divide
    ``n_devices``."""
    n, ep = int(n_devices), int(expert_parallel)
    if ep < 1 or n % ep != 0:
        raise ValueError(f"expert_parallel={expert_parallel} does not divide {n} devices")
    return np.arange(n).reshape(n // ep, ep)


def mesh_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for ``None`` (``LOCAL_RANK``
    from the environment, 0 without it), else ``device``. Raises
    ``RuntimeError`` where CUDA is asked for and no card is visible."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run the mesh on "
                           "the CPU (gloo)")
    return dev


def init_world(rank: int, world_size: int, init_method: str, device=None) -> torch.device:
    """Join the process group of ``world_size`` ranks as ``rank``: NCCL on a
    card (``torch.cuda.set_device`` first), gloo on the CPU. ``init_method``
    is ``file://<path>`` (the tests and the dry run: no port) or
    ``tcp://localhost:<port>``. Returns the rank's device."""
    dist = _dist()
    if device is None:
        os.environ.setdefault("LOCAL_RANK", str(rank))
    dev = mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """The world's ranks on a ``(data, expert)`` grid, seen from one rank.

    ``devices``: the ``[n_data, n_expert]`` grid of global ranks (JAX's
    ``mesh.devices`` holds devices; here each rank is one). ``data_group``:
    the ranks that differ from this one only in their data coordinate;
    ``expert_group``: those that differ only in their expert coordinate."""

    devices: np.ndarray
    rank: int
    device: torch.device
    data_group: Any
    expert_group: Any
    axis_names: Tuple[str, str] = (DATA_AXIS, EXPERT_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's ``(data, expert)`` coordinates."""
        d, e = np.argwhere(self.devices == self.rank)[0]
        return int(d), int(e)

    def __repr__(self) -> str:
        n_data, n_expert = self.devices.shape
        return f"Mesh(data={n_data}, expert={n_expert}, rank={self.rank}, device={self.device})"


def make_mesh(n_devices: Optional[int] = None, expert_parallel: int = 1,
              device=None) -> Mesh:
    """A ``(data, expert)`` mesh over the world's ranks (JAX's ``make_mesh``):
    ``expert_parallel`` ranks along the expert axis, the rest along the data
    axis. ``n_devices`` (``None``: the world size) must equal the world size.

    Collective: every rank calls it, in the same order, after joining the
    process group (:func:`init_world`). ``device`` as :func:`mesh_device`;
    CUDA needs a card a rank and an NCCL group, the CPU a gloo group.
    Raises ``ValueError`` where ``expert_parallel`` does not divide the rank
    count (before any collective) and ``RuntimeError`` without a process
    group or with more ranks than cards."""
    dist = _dist()
    world = dist.get_world_size() if dist.is_initialized() else None
    n = n_devices if n_devices is not None else world
    if n is None:
        raise RuntimeError("make_mesh needs a process group (init_world) or n_devices")
    grid = mesh_grid(n, expert_parallel)
    if world is None:
        raise RuntimeError("make_mesh needs a process group: call init_world (or "
                           "torch.distributed.init_process_group) on every rank first")
    if n != world:
        raise ValueError(f"a mesh spans the whole world: n_devices={n}, world size {world}")
    dev = mesh_device(device)
    backend = str(dist.get_backend()).lower()
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"a CUDA mesh of {world} ranks needs {world} cards; "
                               f"{torch.cuda.device_count()} are visible")
        if "nccl" not in backend:
            raise ValueError(f"a CUDA mesh runs on NCCL, the process group is {backend}")
    elif "gloo" not in backend:
        raise ValueError(f"a CPU mesh runs on gloo, the process group is {backend}")
    rank = dist.get_rank()
    n_data, n_expert = grid.shape
    # dist.new_group is collective: every rank creates every group, in one order
    data_groups = [dist.new_group(grid[:, e].tolist()) for e in range(n_expert)]
    expert_groups = [dist.new_group(grid[d, :].tolist()) for d in range(n_data)]
    d, e = (int(i) for i in np.argwhere(grid == rank)[0])
    return Mesh(grid, rank, dev, data_groups[e], expert_groups[d])


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` of each of the ``n`` ranks of ``group``, concatenated on the
    leading axis in group-rank order (the list form, which gloo and NCCL
    both run)."""
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _dist().all_gather(parts, t, group=group)
    return torch.cat(parts)


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``batch_sharding``: every data rank's rows of ``t``,
    in data-coordinate order, on every rank."""
    return _all_gather(t, mesh.data_group, mesh.shape[DATA_AXIS])


class Placement:
    """Where a leaf lives on the mesh (JAX's ``NamedSharding``): ``spec`` is
    ``()`` (replicated), ``(DATA_AXIS,)`` or ``(EXPERT_AXIS,)`` (the leading
    axis split over that mesh axis), as JAX's ``PartitionSpec``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: Tuple[str, ...] = ()):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self) -> str:
        return f"Placement({self.spec})"

    def place(self, x: Any) -> Any:
        """This rank's piece of ``x`` on the mesh's device (JAX's
        ``device_put``): its block of rows for a split spec (the axis must
        divide the leading dim: ``ValueError``), the whole tensor broadcast
        from rank 0 for ``()`` (collective). A leaf that is not a tensor or
        an array is returned as it is."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not torch.is_tensor(x):
            return x
        if not self.spec:
            t = x.to(self.mesh.device).clone()
            _dist().broadcast(t, src=int(self.mesh.devices.flat[0]))
            return t
        axis = self.spec[0]
        n = self.mesh.shape[axis]
        i = self.mesh.coords[self.mesh.axis_names.index(axis)]
        if x.ndim < 1 or x.shape[0] % n:
            raise ValueError(f"the '{axis}' mesh axis of size {n} does not divide the leading "
                             f"axis of a leaf of shape {tuple(x.shape)}")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].to(self.mesh.device)


def place_tree(placement: Placement, tree: Any) -> Any:
    """:meth:`Placement.place` on every leaf of ``tree``."""
    return _tree_map(placement.place, tree)


def batch_sharding(mesh: Mesh) -> Placement:
    """Batch tensors split their leading (sample) axis over the data axis."""
    return Placement(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def _expert_leaf_sharding(mesh: Mesh, n_experts: int):
    """The rule INSIDE an expert-stacked component: a leaf with a leading
    ``[E, ...]`` axis splits over the expert axis when ``E > 1``; other
    leaves (Adam's step count) replicate."""
    expert_s, repl = Placement(mesh, (EXPERT_AXIS,)), replicated(mesh)

    def rule(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return expert_s if len(shape) >= 1 and shape[0] == n_experts and n_experts > 1 else repl

    return rule


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    rebuilding mappings, lists, tuples, named tuples and dataclasses (the
    port's train state, and the JAX state's Flax structs and optax tuples
    too); a :class:`Placement` and anything else is a leaf."""
    if isinstance(tree, Placement):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        out = {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
        return out if type(tree) is dict else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


_STACKED = ("gen", "disc", "aux")  # the components built by stacking the experts


def _is_state(state: Any) -> bool:
    return all(hasattr(state, a) for a in (*_STACKED, "router"))


def state_shardings(mesh: Mesh, state: Any, n_experts: int) -> Any:
    """A tree of :class:`Placement` shaped as ``state``.

    Structural, as JAX's: only the expert-stacked components (``gen``,
    ``disc``, ``aux`` and ``ema_gen_params``) split their leading ``[E,
    ...]`` axis over the expert axis; the router, the step counter and
    everything else replicate, even a leaf with a leading dim of E (the
    router head's ``(E,)`` bias). A structure without ``gen``, ``disc``,
    ``aux`` and ``router`` replicates whole."""
    rule = _expert_leaf_sharding(mesh, n_experts)
    repl = replicated(mesh)
    replicate = lambda sub: _tree_map(lambda _: repl, sub)  # noqa: E731
    if not _is_state(state):
        return replicate(state)
    return dataclasses.replace(
        state, **{c: _tree_map(rule, getattr(state, c)) for c in _STACKED},
        router=replicate(state.router), ema_gen_params=_tree_map(rule, state.ema_gen_params),
        step=repl)


def shard_state(mesh: Mesh, state: Any, n_experts: int) -> Any:
    """This rank's local piece of a whole ``state`` (every rank passes the
    same one) by :func:`state_shardings`: the expert-stacked leaves cut to
    the rank's experts, the others broadcast from rank 0. Collective."""
    return _tree_map(lambda x, p: p.place(x), state, state_shardings(mesh, state, n_experts))


def gather_state(mesh: Mesh, state: Any, n_experts: int) -> Any:
    """The inverse of :func:`shard_state`: each expert-stacked leaf
    all-gathered over the expert axis back to ``[E, ...]``, on every rank
    (JAX's ``device_put`` to replicated). A leaf of an expert-stacked
    component is taken as split where its leading dim times the expert
    axis's size is ``n_experts`` (such components hold ``[E, ...]`` leaves
    and scalars only). Collective; with one rank on the expert axis, or an
    unknown structure, ``state`` comes back as it is."""
    n = mesh.shape[EXPERT_AXIS]
    if n == 1 or n_experts <= 1 or not _is_state(state):
        return state

    def gather(leaf):
        if torch.is_tensor(leaf) and leaf.ndim >= 1 and leaf.shape[0] * n == n_experts:
            return _all_gather(leaf, mesh.expert_group, n)
        return leaf

    return dataclasses.replace(
        state, **{c: _tree_map(gather, getattr(state, c)) for c in _STACKED},
        ema_gen_params=_tree_map(gather, state.ema_gen_params))
