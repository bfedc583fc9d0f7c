"""Multi-GPU serving on a ``(data, expert)`` mesh of ``torch.distributed``
ranks (counterpart of ``zdcsim/parallel/``).

JAX runs one program over a device mesh and lets its partitioner insert
the collectives. Here each rank is a process on one card (or a CPU rank,
for the tests), and the collectives are explicit:

- **data axis**: a serve's chunk splits over the ranks of the data axis;
  each decodes its rows, and the rows are all-gathered back, so every rank
  returns the whole result (``FastSim(mesh=...)``);
- **expert axis**: a train state's expert-stacked leaves (``[E, ...]``)
  split over it (``shard_state``); serving gathers them once
  (``gather_state``) and replicates the weights.

The train steps on the mesh are not ported yet (ROADMAP.md Queue 1 item
8b). ``python -m zdcsim_torch.parallel.dryrun`` serves on a mesh end to
end.
"""

from zdcsim_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    Mesh,
    Placement,
    batch_sharding,
    gather_state,
    init_world,
    gather_rows,
    make_mesh,
    mesh_grid,
    place_tree,
    replicated,
    shard_state,
    state_shardings,
)
