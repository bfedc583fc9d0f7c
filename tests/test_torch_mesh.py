"""The port's ``(data, expert)`` mesh (``zdcsim_torch.parallel.mesh``)
against the JAX package's (``zdcsim/parallel/mesh.py``), on the CPU.

``make_mesh``'s layout and its ``ValueError`` against JAX's on the 8
virtual CPU devices (``tests/test_parallel.py:38``); the placement rule
leaf for leaf against JAX's ``state_shardings`` on JAX's tiny state
(``tests/test_parallel.py:46``), the router's ``(E,)`` bias included, and
on that state carried into the port; then, in a gloo world of 4 ranks
(data 2 x expert 2) spawned by a subprocess under a hard time limit and
meeting through a ``file://`` store, ``shard_state`` then ``gather_state``
``torch.equal`` to the whole state, the groups, the batch placement and
its gather, and ``make_mesh``'s refusals inside a world.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from zdcsim_torch.parallel import mesh as M

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD_TIMEOUT = 45  # seconds: the world's subprocess is killed, ranks and all, after it


def run_world(fn_name, world, tmp, *args, timeout=WORLD_TIMEOUT):
    """``fn_name`` of this module on ``world`` gloo ranks (one intra-op
    thread each; ``zdcsim_torch.parallel.dryrun.run_world``) with the store
    ``<tmp>/store``, in a subprocess of its own session, killed with every
    rank after ``timeout`` seconds."""
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"from zdcsim_torch.parallel.dryrun import run_world; "
            f"import {__name__.split('.')[-1]} as m; "
            f"run_world(m.{fn_name}, {world}, args={(str(tmp), *args)!r}, store_dir={str(tmp)!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the world of {world} ranks ran over {timeout} s:\n{err[-3000:]}")
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return out


# -- the layout, without a process group -----------------------------------

@pytest.mark.parametrize("n,ep", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (4, 1), (1, 1)])
def test_layout_matches_jax(cpu_devices, n, ep):
    from zdcsim.parallel.mesh import make_mesh as jax_make_mesh

    ref = jax_make_mesh(n_devices=n, expert_parallel=ep)
    grid = M.mesh_grid(n, ep)
    assert grid.shape == ref.devices.shape
    np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(ref.devices))
    assert (M.DATA_AXIS, M.EXPERT_AXIS) == tuple(ref.axis_names)


@pytest.mark.parametrize("n,ep", [(8, 3), (4, 3), (6, 4)])
def test_layout_refusals_match_jax(cpu_devices, n, ep):
    from zdcsim.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(ValueError):
        jax_make_mesh(n_devices=min(n, 8), expert_parallel=ep)
    with pytest.raises(ValueError, match=f"expert_parallel={ep} does not divide {n}"):
        M.mesh_grid(n, ep)
    with pytest.raises(ValueError, match="does not divide"):  # before any collective
        M.make_mesh(n_devices=n, expert_parallel=ep, device="cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh(n_devices=4, expert_parallel=2, device="cpu")


# -- the placement rule against JAX's ----------------------------------------

@pytest.fixture(scope="module")
def jax_tiny_state():
    import jax

    from zdcsim.config import load_config
    from zdcsim.models.testing import build_tiny_moe
    from zdcsim.train.state import init_state

    cfg = load_config(overrides=["model.n_experts=4", "train.batch_size=16",
                                 "dataset.input_image_shape=[8, 6]"])
    return init_state(build_tiny_moe(cfg, (8, 6)), cfg, jax.random.PRNGKey(0))


def layout_mesh(n=8, ep=2):
    """A mesh's layout seen from rank 0, without groups (the rule reads the
    layout only)."""
    return M.Mesh(M.mesh_grid(n, ep), 0, torch.device("cpu"), None, None)


def test_placement_rule_matches_jax_leaf_for_leaf(cpu_devices, jax_tiny_state):
    import jax
    from jax.sharding import PartitionSpec as P

    from zdcsim.parallel.mesh import make_mesh as jax_make_mesh
    from zdcsim.parallel.mesh import state_shardings as jax_state_shardings

    state = jax_tiny_state
    ref = jax_state_shardings(jax_make_mesh(n_devices=8, expert_parallel=2), state, 4)
    ours = M.state_shardings(layout_mesh(), state, 4)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = jax.tree_util.tree_leaves(ours)
    assert len(ref_leaves) == len(our_leaves) == len(jax.tree_util.tree_leaves(state))
    n_expert = 0
    for (path, r), o in zip(ref_leaves, our_leaves):
        assert isinstance(o, M.Placement)
        assert o.spec == tuple(r.spec), jax.tree_util.keystr(path)
        n_expert += o.spec == (M.EXPERT_AXIS,)
    assert n_expert > 0
    # the router's (E,)-shaped bias replicates: the rule is structural
    e_sized = [o for o, leaf in zip(jax.tree_util.tree_leaves(ours.router.params),
                                    jax.tree_util.tree_leaves(state.router.params))
               if getattr(leaf, "shape", ()) and leaf.shape[0] == 4]
    assert e_sized and all(o.spec == () for o in e_sized)
    assert ours.step.spec == tuple(P()) == ()
    # an unknown structure replicates whole
    assert all(p.spec == () for p in jax.tree_util.tree_leaves(
        M.state_shardings(layout_mesh(), {"a": np.zeros((4, 3))}, 4)))


def test_placement_rule_on_the_carried_state(jax_tiny_state):
    """JAX's state carried into the port: the expert-stacked components'
    ``[E, ...]`` leaves split, their Adam counts, the router and the step
    replicate; as many leaves split in each component as in JAX's."""
    import jax

    from zdcsim_torch.convert import train_state_from_jax

    state = train_state_from_jax(jax_tiny_state, "cpu")
    rule = M.state_shardings(layout_mesh(), state, 4)
    for comp in ("gen", "disc", "aux"):
        ours, ref = getattr(rule, comp), getattr(jax_tiny_state, comp)
        for group in ("params", "stats"):
            specs = [p.spec for p in getattr(ours, group).values()]
            assert all(s == (M.EXPERT_AXIS,) for s in specs), (comp, group)
            assert len(specs) == len(jax.tree_util.tree_leaves(getattr(ref, group))), (comp, group)
        assert ours.params
        adam = ours.opt_state
        assert adam.count.spec == ()
        assert all(p.spec == (M.EXPERT_AXIS,) for t in (adam.mu, adam.nu) for p in t.values())
    assert all(p.spec == (M.EXPERT_AXIS,) for p in rule.ema_gen_params.values())
    assert all(p.spec == () for p in rule.router.params.values())
    assert rule.step.spec == ()


# -- shard, gather and place in a gloo world of 4 (data 2 x expert 2) -------

def _shard_gather_rank(rank, world, dev, tmp):
    import dataclasses

    import torch.distributed as dist

    from zdcsim_torch.config import load_config
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.train.state import init_state

    with pytest.raises(ValueError, match="spans the whole world"):
        M.make_mesh(n_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh(expert_parallel=2)
    mesh = M.make_mesh(expert_parallel=2, device="cpu")
    d, e = mesh.coords
    assert mesh.shape == {"data": 2, "expert": 2} and rank == 2 * d + e
    # the groups: the data group spans the ranks of this expert coordinate
    t = torch.tensor([rank])
    dist.all_reduce(t, group=mesh.data_group)
    assert int(t) == e + (2 + e)
    t = torch.tensor([rank])
    dist.all_reduce(t, group=mesh.expert_group)
    assert int(t) == 2 * d + (2 * d + 1)

    cfg = load_config(["model.n_experts=4", "dataset.input_image_shape=[8, 6]"])
    state = init_state(build_tiny_moe(cfg, (8, 6)), cfg, 0, "cpu")
    local = M.shard_state(mesh, state, 4)
    split = [0]

    def check(comp_local, comp_whole):
        def leaf(a, b):
            if torch.is_tensor(b) and b.ndim >= 1 and b.shape[0] == 4:
                assert torch.equal(a, b[2 * e:2 * e + 2])
                split[0] += 1
            else:
                assert torch.equal(a, b)
            return a
        M._tree_map(leaf, comp_local, comp_whole)

    for c in ("gen", "disc", "aux", "ema_gen_params"):
        check(getattr(local, c), getattr(state, c))
    for c in ("router", "step"):
        M._tree_map(same, getattr(local, c), getattr(state, c))
    assert split[0] > 0
    back = M.gather_state(mesh, local, 4)
    M._tree_map(same, back, state)
    assert dataclasses.fields(back) == dataclasses.fields(state)

    # the batch placement and its gather
    x = torch.arange(24.0).reshape(8, 3)
    rows = M.batch_sharding(mesh).place(x)
    assert torch.equal(rows, x[4 * d:4 * d + 4])
    assert torch.equal(M.gather_rows(mesh, rows), x)
    with pytest.raises(ValueError, match="does not divide"):
        M.batch_sharding(mesh).place(torch.zeros(3, 2))
    # replicated: rank 0's tensor on every rank
    assert torch.equal(M.replicated(mesh).place(torch.full((2,), float(rank))), torch.zeros(2))
    with open(os.path.join(tmp, f"ok{rank}"), "w") as f:
        f.write(f"{split[0]}")


def same(a, b):
    """``a``, asserted equal to ``b`` (``torch.equal`` for tensors)."""
    assert torch.equal(a, b) if torch.is_tensor(b) else a == b
    return a


def test_shard_then_gather_in_a_world_of_4(tmp_path):
    run_world("_shard_gather_rank", 4, tmp_path)
    counts = {(tmp_path / f"ok{r}").read_text() for r in range(4)}
    assert len(counts) == 1 and int(counts.pop()) > 0
