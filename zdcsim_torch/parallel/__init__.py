"""Training and serving on a ``(data, expert)`` mesh of
``torch.distributed`` ranks (counterpart of ``zdcsim/parallel/``).

JAX runs one program over a device mesh and lets its partitioner insert
the collectives. Here each rank is a process on one card (or a CPU rank,
for the tests), and the collectives are explicit:

- **data axis**: a batch splits over the ranks of the data axis. A serve's
  rows are all-gathered back, so every rank returns the whole result
  (``FastSim(mesh=...)``); a train step gathers each rank's per-row
  losses' inputs and sums the gradients over the axis
  (``build_train_step(mesh=...)``, ``collectives``);
- **expert axis**: a train state's expert-stacked leaves (``[E, ...]``)
  split over it (``shard_state``). The dense train step runs a rank's
  experts; the switch step and serving gather the weights at the dispatch
  (``gather_state``).

``train()`` runs on a mesh under ``torchrun``; ``python -m
zdcsim_torch.parallel.dryrun`` trains and serves on a mesh end to end.
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
