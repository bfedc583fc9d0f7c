"""Training on a ``(data, expert)`` mesh: the port's dense and switch steps
on ``torch.distributed`` against the meshless port step and against the
JAX package's sharded step, the neutron ``norm=batch`` step, the switch
step's batch rule, and ``train()`` on a mesh with its checkpoints, on the
CPU.

Two gloo worlds of 4 ranks, data 4 x expert 1 (E=3) and data 2 x expert 2
(E=4), as ``tests/test_parallel.py:152``, each spawned by a subprocess in a
session of its own under a hard time limit, meeting through a ``file://``
store, one intra-op thread a rank (the harness of
``tests/test_torch_mesh_serve.py``). Both start while this process builds
JAX's states and compiles its sharded step.

- The steps: the tiny modules (``build_tiny_moe``), batch 16, from one JAX
  state carried across (``convert.train_state_from_jax``) on JAX's draws
  (``k_gumbel``, ``k_n1``, ``k_n2`` of the step's key; the tiny modules
  have no dropout) and the batch of ``tests/test_parallel.py:76``; dense
  and switch (tile 4). Held against the meshless port step on the whole
  batch at JAX's sharded tolerances (``tests/test_parallel.py:205-220``):
  metrics rtol 2e-4 / atol 1e-5, parameters rtol 2e-3 / atol 2 lr + 1e-5;
  Adam's moments by relative norm per leaf (``MOMENT_RTOL``, the neutron
  step tests' bound and reason); every other leaf rtol 2e-3 / atol 1e-5;
  every rank's metrics and gathered state equal to rank 0's, and a second
  run of each mesh step from the same piece equal to the first. The dense
  step on the 2 x 2 world is also held against JAX's sharded step on 8
  virtual devices at expert_parallel 2 (``tests/test_parallel.py:76``), its
  ``gen_loss`` at that test's rtol 1e-4.
- The neutron family at width 0.125, ``norm=batch``, E=3, batch 16 on the
  4 x 1 world: ``MaskedBatchNorm``'s statistics summed over the data axis,
  the running statistics held with the rest of the state.
- A batch of 6 on the 2 x 2 world: the switch step raises ``ValueError``
  naming the multiple 4.
- ``train()`` on the 2 x 2 world in ``tests/test_parallel.py:253``'s
  configuration (synthetic 128 events at 8 x 6, batch 32, 2 epochs, E=4),
  saving a checkpoint each epoch: every rank's history equal, finite, with
  ``ws_mean``; the last checkpoint restored in this process equal to the
  gathered state the run returned; a resume onto the mesh from epoch 1.
- ``train()`` asked for a mesh with no process group raises, naming
  ``torchrun``.
- ``DeviceLoader(mesh=...)`` yields each data rank its block of the
  meshless loader's batches, on every expert coordinate.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_mesh_serve import Launched

TESTS = os.path.dirname(os.path.abspath(__file__))
B, SHAPE = 16, (8, 6)
LAYOUTS = {"4x1": 1, "2x2": 2}  # name -> expert_parallel, in a world of 4
EXPERTS = {"4x1": 3, "2x2": 4}
LRS = {"gen": 1e-4, "disc": 1e-5, "aux": 1e-4, "router": 1e-4}  # default.yaml
# Adam's moments per leaf, by relative norm error (a leaf under 1% of its
# component's norm against that 1%): tests/test_torch_neutron_train_step.py's
# bound, for its reason (a LeakyReLU input within ~1e-6 of the kink takes
# the other slope when the data ranks sum in another order)
MOMENT_RTOL = 1e-2


def launch_world(fn_name, world, tmp, *args):
    """``fn_name`` of this module on ``world`` gloo ranks with the store
    ``<tmp>/store``, launched in a subprocess killed after
    ``test_torch_mesh_serve.WORLD_TIMEOUT`` seconds."""
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"from zdcsim_torch.parallel.dryrun import run_world; "
            f"import {__name__.split('.')[-1]} as m; "
            f"run_world(m.{fn_name}, {world}, args={(str(tmp), *args)!r}, store_dir={str(tmp)!r})")
    return Launched([sys.executable, "-c", code], f"the world of {world} ranks in {tmp}")


def step_overrides(n_experts, dispatch="dense", batch=B):
    return [f"model.n_experts={n_experts}", f"train.batch_size={batch}",
            f"dataset.input_image_shape=[{SHAPE[0]}, {SHAPE[1]}]", f"train.dispatch={dispatch}",
            "train.dispatch_tile=4"]


NEUTRON = ["model.architecture=neutron", "dataset.zdc_type=neutron",
           "dataset.input_image_shape=[44, 44]", "model.norm=batch", "model.generator.width=0.125",
           "model.n_experts=3", f"train.batch_size={B}"]


def loop_overrides(tmp, parallel=("parallel.n_devices=4", "parallel.expert_parallel=2")):
    """``tests/test_parallel.py:253``'s run on a world of 4, saving each epoch."""
    return ["dataset.synthetic=true", "dataset.synthetic_n_samples=128",
            f"dataset.input_image_shape=[{SHAPE[0]}, {SHAPE[1]}]", "train.batch_size=32",
            "train.epochs=2", "train.eval_every=1", "model.n_experts=4", *parallel,
            f"train.save_experiments_dir={tmp}/runs/", "train.save_experiment_data=true",
            "train.ws_threshold_model_save=1e30"]


# -- one rank ------------------------------------------------------------------

def _flat(state):
    from zdcsim_torch.train.checkpoint import _flatten

    return {k: v.detach().numpy() for k, v in _flatten(state).items()}


def _step_pair(mesh, modules, cfg, state, batch, draws, rank, tag, out):
    """The mesh step's metrics and gathered state on every rank, whether a
    second run from the same piece is equal to the first, and the meshless
    step's on rank 0, into ``out`` under ``tag``."""
    from zdcsim_torch.parallel.mesh import batch_sharding, gather_state, place_tree, shard_state
    from zdcsim_torch.train.checkpoint import _flatten
    from zdcsim_torch.train.step import build_train_step

    E = modules.n_experts
    step = build_train_step(modules, cfg, mesh)
    local, rows = shard_state(mesh, state, E), place_tree(batch_sharding(mesh), batch)
    new, metrics = step(local, rows, draws, 0)
    again, metrics2 = step(local, rows, draws, 0)
    out[f"{tag}/repeat_equal"] = np.array(
        all(torch.equal(metrics[k], metrics2[k]) for k in metrics)
        and all(torch.equal(a, b) for a, b in zip(_flatten(new).values(),
                                                  _flatten(again).values())))
    out.update({f"{tag}/metric/{k}": v.numpy() for k, v in metrics.items()})
    out.update({f"{tag}/state/{k}": v for k, v in _flat(gather_state(mesh, new, E)).items()})
    if rank == 0:
        ref, ref_metrics = build_train_step(modules, cfg)(state, batch, draws, 0)
        out.update({f"{tag}/plain_metric/{k}": v.numpy() for k, v in ref_metrics.items()})
        out.update({f"{tag}/plain_state/{k}": v for k, v in _flat(ref).items()})


def _steps_rank(rank, world, dev, tmp, ep):
    """Both steps (and on 4 x 1 the neutron step, on 2 x 2 the switch
    step's batch error) on one rank; writes ``<tmp>/rank{r}.npz``."""
    from zdcsim_torch.config import load_config
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.parallel.mesh import batch_sharding, make_mesh, place_tree, shard_state
    from zdcsim_torch.train.state import init_state
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        inp = {k: torch.from_numpy(v) for k, v in f.items()}
    batch = {k: inp[k] for k in ("real", "cond", "std", "intensity", "positions")}
    draws = {"gumbel": inp["gumbel"], "noise_1": inp["noise_1"], "noise_2": inp["noise_2"],
             "aux_keep": ()}
    state = torch.load(os.path.join(tmp, "state.pt"), weights_only=False)
    n_exp = 3 if ep == 1 else 4
    mesh = make_mesh(expert_parallel=ep, device="cpu")
    out = {}
    for dispatch in ("dense", "switch"):
        cfg = load_config(step_overrides(n_exp, dispatch))
        _step_pair(mesh, build_tiny_moe(cfg, SHAPE), cfg, state, batch, draws, rank, dispatch,
                   out)
    if ep == 1:
        cfg = load_config(NEUTRON)
        modules = build_moe(cfg)
        n_state = init_state(modules, cfg, 4, "cpu")
        rng = np.random.default_rng(12)
        n_batch = {"real": rng.random((B, 44, 44, 1)) * 3, "cond": rng.standard_normal((B, 9)),
                   "std": rng.random((B, 1)), "intensity": rng.random((B, 1)) * 500,
                   "positions": rng.random((B, 2)) * 20}
        n_batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in n_batch.items()}
        n_draws = draw_step_noise(torch.Generator().manual_seed(13), modules, B, "cpu")
        _step_pair(mesh, modules, cfg, n_state, n_batch, n_draws, rank, "neutron", out)
    else:
        cfg = load_config(step_overrides(n_exp, "switch", 6))
        modules = build_tiny_moe(cfg, SHAPE)
        step = build_train_step(modules, cfg, mesh)
        six = {k: v[:6] for k, v in batch.items()}
        try:
            step(shard_state(mesh, state, n_exp), place_tree(batch_sharding(mesh), six),
                 draw_step_noise(torch.Generator().manual_seed(0), modules, 6, "cpu", True), 0)
            out["switch_error"] = np.array("")
        except ValueError as e:
            out["switch_error"] = np.array(str(e))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def _loop_rank(rank, world, dev, tmp):
    """``train()`` on the 2 x 2 mesh, then a resume onto it from epoch 1."""
    import json

    from zdcsim_torch.config import load_config
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.train.loop import train

    cfg = load_config(loop_overrides(tmp))
    modules = build_tiny_moe(cfg, SHAPE)
    history, whole = train(cfg, modules=modules, return_state=True, device="cpu")
    run_dir = str(cfg.config.experiment_dir)
    resume = load_config(loop_overrides(tmp) + [f"train.checkpoint_experiment_dir={run_dir}",
                                                "train.epoch_to_load=1",
                                                "train.save_experiment_data=false"])
    resumed = train(resume, modules=build_tiny_moe(resume, SHAPE), device="cpu")
    with open(os.path.join(tmp, f"loop{rank}.json"), "w") as f:
        json.dump({"history": history, "resumed": resumed, "run_dir": run_dir}, f)
    if rank == 0:
        torch.save(whole, os.path.join(tmp, "whole.pt"))


def _world_rank(rank, world, dev, tmp, ep):
    _steps_rank(rank, world, dev, tmp, ep)
    if ep == 2:
        _loop_rank(rank, world, dev, tmp)


# -- the worlds and JAX's sharded step ------------------------------------------

def jax_setting(n_experts):
    """``tests/test_parallel.py:76``'s state (``PRNGKey(0)``), batch (``mk``
    on ``PRNGKey(1)``) and step key (``PRNGKey(2)``) for the tiny modules,
    with the draws of JAX's step on that key."""
    import jax
    import jax.numpy as jnp

    from zdcsim.config import load_config as jax_config
    from zdcsim.models.testing import build_tiny_moe as jax_tiny
    from zdcsim.train.state import init_state

    cfg = jax_config(overrides=step_overrides(n_experts))
    modules = jax_tiny(cfg, SHAPE)
    state = init_state(modules, cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    mk = lambda i, shape: np.asarray(jnp.abs(jax.random.normal(  # noqa: E731
        jax.random.fold_in(key, i), shape)))
    batch = {"real": mk(0, (B, *SHAPE, 1)), "cond": mk(1, (B, 9)), "std": mk(2, (B, 1)),
             "intensity": mk(3, (B, 1)), "positions": mk(4, (B, 2))}
    step_key = jax.random.PRNGKey(2)
    k_gumbel, k_n1, k_n2 = jax.random.split(step_key, 6)[:3]
    draws = {"gumbel": np.asarray(jax.random.gumbel(k_gumbel, (B, n_experts))),
             "noise_1": np.asarray(jax.random.normal(k_n1, (B, modules.noise_dim))),
             "noise_2": np.asarray(jax.random.normal(k_n2, (B, modules.noise_dim)))}
    return cfg, modules, state, batch, step_key, draws


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds, started at once; JAX's sharded step runs here meanwhile:
    ``{layout: (Launched, tmp)}`` and ``"jax"``: the 2 x 2 setting's JAX
    objects."""
    from zdcsim_torch.convert import train_state_from_jax

    out = {}
    for layout, ep in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(f"world_{layout}")
        setting = jax_setting(EXPERTS[layout])
        _, _, state, batch, _, draws = setting
        np.savez(tmp / "inputs.npz", **batch, **draws)
        torch.save(train_state_from_jax(state, "cpu"), tmp / "state.pt")
        out[layout] = launch_world("_world_rank", 4, tmp, ep), tmp
        if layout == "2x2":
            out["jax"] = setting
    yield out
    for name, v in out.items():
        if name != "jax":
            v[0].kill()


@pytest.fixture(scope="module")
def jax_sharded(cpu_devices, launched):
    """JAX's sharded dense step's metrics on 8 virtual devices at
    expert_parallel 2 (``tests/test_parallel.py:76``)."""
    import jax
    import jax.numpy as jnp

    from zdcsim.parallel.mesh import batch_sharding, make_mesh, shard_state
    from zdcsim.train.step import build_train_step

    cfg, modules, state, batch, key, _ = launched["jax"]
    mesh = make_mesh(n_devices=8, expert_parallel=2)
    state = shard_state(mesh, state, 4)
    bsh = batch_sharding(mesh)
    step = build_train_step(modules, cfg, mesh=mesh, example_state=state)
    _, metrics = step(state, {k: jax.device_put(jnp.asarray(v), bsh) for k, v in batch.items()},
                      key, jnp.asarray(0))
    return {k: np.asarray(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def results(launched):
    """``{layout: [rank results]}`` of both worlds of 4."""
    out = {}
    for layout in LAYOUTS:
        proc, tmp = launched[layout]
        proc.wait()
        out[layout] = []
        for r in range(4):
            with np.load(tmp / f"rank{r}.npz") as f:
                out[layout].append(dict(f))
    return out


def of(results, prefix):
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


def assert_step_matches(r, tag):
    """The mesh step against the meshless one at JAX's sharded tolerances."""
    ours, ref = of(r, f"{tag}/metric/"), of(r, f"{tag}/plain_metric/")
    assert ours and sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=2e-4, atol=1e-5, err_msg=f"{tag} {k}")
    ours, ref = of(r, f"{tag}/state/"), of(r, f"{tag}/plain_state/")
    assert ours and sorted(ours) == sorted(ref)
    moments = {}
    for k, v in ref.items():
        comp, _, kind = k.partition("/")
        if kind.startswith(("opt_state/mu/", "opt_state/nu/")):
            moments.setdefault((comp, kind.split("/")[1]), []).append(k)
            continue
        if kind.startswith("params/"):
            atol = 2 * LRS[comp] + 1e-5
        elif comp == "ema_gen_params":
            atol = 2 * 0.01 * LRS["gen"] + 1e-5
        else:
            atol = 1e-5
        np.testing.assert_allclose(ours[k], v, rtol=2e-3, atol=atol, err_msg=f"{tag} {k}")
    for keys in moments.values():  # Adam's moments: relative norm error per leaf
        total = np.sqrt(sum(np.linalg.norm(ref[k]) ** 2 for k in keys))
        for k in keys:
            scale = max(np.linalg.norm(ref[k]), 1e-2 * total)
            assert np.linalg.norm(ours[k] - ref[k]) <= MOMENT_RTOL * scale, (tag, k)
    return ours, ref


# -- the checks --------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dispatch", ["dense", "switch"])
def test_mesh_step_matches_the_meshless_step(results, layout, dispatch):
    ours, _ = assert_step_matches(results[layout][0], dispatch)
    assert all(np.isfinite(v).all() for v in ours.values())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dispatch", ["dense", "switch"])
def test_mesh_step_run_twice_is_equal(results, layout, dispatch):
    """Two runs of a mesh step from one piece of the state are equal bit for
    bit on every rank (the step's determinism, collectives included)."""
    assert all(bool(r[f"{dispatch}/repeat_equal"]) for r in results[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_returns_the_same(results, layout):
    ranks = results[layout]
    keys = [k for k in ranks[0] if "/metric/" in k or "/state/" in k]
    assert len(keys) > 40
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=f"{layout} {k}")


def test_dense_mesh_step_matches_jax_sharded(results, jax_sharded):
    ranks = results["2x2"]  # JAX's sharded step runs at expert_parallel 2, E=4
    ours = float(ranks[0]["dense/metric/gen_loss"])
    np.testing.assert_allclose(ours, float(jax_sharded["gen_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(np.sum(ranks[0]["dense/metric/n_choosen_experts_mean_epoch"])),
                               1.0, rtol=1e-6)


def test_neutron_batch_norm_step_on_the_mesh(results):
    ranks = results["4x1"]
    ours, ref = assert_step_matches(ranks[0], "neutron")  # the running statistics included
    bn = [k for k in ref if k.startswith(("gen/stats/", "aux/stats/"))
          and k.endswith(("|mean", "|var"))]
    assert len(bn) >= 4
    for k in bn:  # they moved from their start (mean 0, var 1)
        assert np.abs(ours[k] - (0.0 if k.endswith("|mean") else 1.0)).max() > 1e-4, k
    for r in ranks[1:]:
        for k in bn:
            np.testing.assert_array_equal(r[f"neutron/state/{k}"], ours[k])


def test_switch_batch_not_divisible_raises(results):
    for r in results["2x2"]:  # 6 rows divide the data axis of 2, not the grid of 4
        msg = str(r["switch_error"])
        assert "train.batch_size=6 must be a multiple of 4" in msg, msg


@pytest.fixture(scope="module")
def loop(launched):
    import json

    proc, tmp = launched["2x2"]
    proc.wait()
    runs = []
    for r in range(4):
        with open(tmp / f"loop{r}.json") as f:
            runs.append(json.load(f))
    return tmp, runs


def test_train_on_the_mesh_every_rank_equal(loop):
    _, runs = loop
    history = runs[0]["history"]
    assert len(history) == 2 and "ws_mean" in history[-1]
    assert all(np.isfinite(v) for h in history for k, v in h.items()
               if isinstance(v, float) and k != "epoch_time")
    drop = lambda h: [{k: v for k, v in e.items() if k != "epoch_time"} for e in h]  # noqa: E731
    for r in runs[1:]:
        assert drop(r["history"]) == drop(history)
        assert drop(r["resumed"]) == drop(runs[0]["resumed"])
        assert r["run_dir"] == runs[0]["run_dir"]


def test_mesh_checkpoint_restores_on_one_process(loop):
    from zdcsim_torch.config import load_config
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.train.checkpoint import latest_epoch, restore_checkpoint
    from zdcsim_torch.train.state import init_state
    from zdcsim_torch.utils.io import DIR_MODELS

    tmp, runs = loop
    models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=runs[0]["run_dir"])
    assert latest_epoch(models) == 1
    cfg = load_config(loop_overrides(tmp))
    state = restore_checkpoint(models, 1, init_state(build_tiny_moe(cfg, SHAPE), cfg, 0, "cpu"))
    whole = torch.load(tmp / "whole.pt", weights_only=False)
    a, b = _flat(state), _flat(whole)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert all(v.shape[0] == 4 for k, v in a.items() if k.startswith("gen/params/"))


def test_resume_onto_the_mesh(loop):
    _, runs = loop
    resumed = runs[0]["resumed"]
    assert [h["epoch"] for h in resumed] == [1]
    assert np.isfinite(resumed[0]["gen_loss"]) and "ws_mean" in resumed[0]


def test_train_without_a_process_group_names_torchrun(tmp_path):
    from zdcsim_torch.config import load_config
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.train.loop import train

    for parallel in (["parallel.n_devices=2"], ["parallel.expert_parallel=2"]):
        cfg = load_config(loop_overrides(tmp_path, parallel))
        with pytest.raises(RuntimeError, match="no process group is initialized.*|torchrun"):
            train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")
    cfg = load_config(loop_overrides(tmp_path) + ["model.n_experts=3"])
    with pytest.raises(ValueError, match="must divide model.n_experts=3"):
        train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")


def test_loader_yields_each_data_rank_its_rows():
    """``DeviceLoader(mesh=...)``: every rank takes the epoch's order and keeps
    its data rank's block of each global batch, whatever its expert
    coordinate; the blocks in data order are the meshless loader's batch."""
    from types import SimpleNamespace

    from zdcsim_torch.data.loader import DeviceLoader

    rng = np.random.default_rng(5)
    arrays = {"real": rng.random((37, *SHAPE, 1)).astype(np.float32),
              "cond": rng.standard_normal((37, 9)).astype(np.float32)}
    whole = DeviceLoader(arrays, 8, seed=3, device="cpu")

    def mesh(d, e):
        return SimpleNamespace(shape={"data": 2, "expert": 2}, coords=(d, e),
                               device=torch.device("cpu"))

    ranks = {(d, e): DeviceLoader(arrays, 8, seed=3, mesh=mesh(d, e)) for d in (0, 1)
             for e in (0, 1)}
    for epoch in (0, 1):
        pieces = {k: list(v.epoch(epoch)) for k, v in ranks.items()}
        for b, batch in enumerate(whole.epoch(epoch)):
            for e in (0, 1):
                for k, v in batch.items():
                    got = torch.cat([pieces[(d, e)][b][k] for d in (0, 1)])
                    assert torch.equal(got, v), (epoch, b, e, k)
    with pytest.raises(ValueError, match="batch_size 7 must be divisible by the 'data' mesh"):
        DeviceLoader(arrays, 7, mesh=mesh(0, 0))
