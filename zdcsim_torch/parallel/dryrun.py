"""Train and serve on a ``(data, expert)`` mesh end to end: JAX's
``__graft_entry__.dryrun_multichip``.

    python -m zdcsim_torch.parallel.dryrun --world 4 --cpu   # 4 gloo ranks on the CPU
    python -m zdcsim_torch.parallel.dryrun                   # one NCCL rank per visible card
    torchrun --nproc-per-node 4 -m zdcsim_torch.parallel.dryrun --cpu  # ranks from torchrun

Each rank joins the world (a ``file://`` store in a temporary directory, or
torchrun's ``env://``) and builds the mesh (``expert_parallel`` 2 where the
world is even). It first runs one dense and one switch train step of the
tiny modules (``build_tiny_moe``, E=4, batch ``4 * N``, tile 2) on the mesh
from one seeded state and one set of global draws (:func:`train_steps`),
and holds each against the meshless step on the whole batch at JAX's
sharded tolerances (metrics rtol 2e-4 / atol 1e-5, parameters rtol 2e-3 /
atol 2 lr + 1e-5, ``tests/test_parallel.py:205-220``), every rank's
metrics and gathered state equal to rank 0's. Then it builds a fresh
width-0.125 proton train state with E=4 from one seed, cuts it to its
piece (``shard_state``), builds ``FastSim.from_state(mesh=...)`` (which
gathers it) and serves ``16 * N`` conditions through ``simulate_switch``.
It fails unless every rank returns the same finite ``[16 * N, 56, 30]``
showers, routed as the meshless engine on the whole state routes them and
within JAX's sharded-serving tolerance of it (rtol 1e-5, atol 1e-6,
``tests/test_parallel.py:131``). Rank 0 prints one ``dryrun_multigpu OK:
mesh=... trained=... served=...`` line.

:func:`run_world` starts a world of spawned ranks for any module-level
function; the tests use it too.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import torch

from zdcsim_torch.parallel.mesh import init_world

WIDTH, N_EXPERTS, SEED = 0.125, 4, 0


def _rank_entry(rank: int, fn, world: int, init_method: str, cpu: bool, args: tuple) -> None:
    """One rank: one intra-op thread, join the world, run ``fn(rank, world,
    device, *args)``, leave the world."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = init_world(rank, world, init_method, "cpu" if cpu else None)
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, args: tuple = (), cpu: bool = True,
              store_dir: str | None = None) -> None:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks (gloo
    on the CPU, or NCCL with one card a rank) that meet through the
    ``file://`` store ``<store_dir>/store`` (``None``: a fresh temporary
    directory, removed after); returns when every rank has returned, and
    raises where one failed. ``fn`` must be a module-level function (the
    ranks import it)."""
    import torch.multiprocessing as mp

    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="zdcsim_world_") if own else store_dir
    try:
        init_method = "file://" + os.path.join(store_dir, "store")
        mp.start_processes(_rank_entry, args=(fn, world, init_method, cpu, args),
                           nprocs=world, start_method="spawn", join=True)
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)


def _flat(state) -> dict:
    from zdcsim_torch.train.checkpoint import _flatten

    return _flatten(state)


def unequal_across_ranks(mesh, tensors: dict) -> list:
    """The names of ``tensors`` whose value on this rank is not rank 0's
    (collective: each is broadcast from rank 0)."""
    import torch.distributed as dist

    bad = []
    for k, v in tensors.items():
        first = v.detach().clone().contiguous()
        dist.broadcast(first, src=int(mesh.devices.flat[0]))
        if not torch.equal(first, v):
            bad.append(k)
    return bad


def step_disagreement(ours, ref, metrics, ref_metrics, lrs) -> list:
    """Where a mesh step's gathered state and metrics leave the meshless
    step's: metrics beyond rtol 2e-4 / atol 1e-5, parameters beyond rtol
    2e-3 / atol 2 lr + 1e-5 (JAX's sharded tolerances), any other leaf beyond
    rtol 2e-3 / atol 1e-5."""
    bad = [f"metric {k}" for k, v in ref_metrics.items()
           if not torch.allclose(metrics[k], v, rtol=2e-4, atol=1e-5)]
    a, b = _flat(ours), _flat(ref)
    for k, v in b.items():
        comp, _, kind = k.partition("/")
        atol = 2 * lrs[comp] + 1e-5 if kind.startswith("params/") and comp in lrs else 1e-5
        if not torch.allclose(a[k].float(), v.float(), rtol=2e-3, atol=atol):
            bad.append(f"{k} off by {(a[k].float() - v.float()).abs().max().item():.3e}")
    return bad


def train_steps(mesh, dev: torch.device, batch_size: int, seed: int = SEED) -> dict:
    """One dense and one switch step of the tiny modules on ``mesh`` against
    the meshless step on the global batch (see the module doc); returns
    ``{dispatch: {"metrics": ..., "seconds": ...}}``. Raises
    ``RuntimeError`` on a disagreement on any rank."""
    import numpy as np

    from zdcsim_torch.config import load_config
    from zdcsim_torch.models.testing import build_tiny_moe
    from zdcsim_torch.parallel.mesh import batch_sharding, gather_state, place_tree, shard_state
    from zdcsim_torch.train.state import init_state, make_optimizers
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    shape, b = (8, 6), int(batch_size)
    rng = np.random.default_rng([seed, 24])
    batch = {"real": rng.random((b, *shape, 1)) * 3, "cond": rng.standard_normal((b, 9)),
             "std": rng.random((b, 1)), "intensity": rng.random((b, 1)) * 500,
             "positions": rng.random((b, 2)) * 20}
    batch = {k: torch.as_tensor(v.astype(np.float32), device=dev) for k, v in batch.items()}
    out, problems = {}, []
    for dispatch in ("dense", "switch"):
        cfg = load_config([f"model.n_experts={N_EXPERTS}", f"train.batch_size={b}",
                           f"train.dispatch={dispatch}", "train.dispatch_tile=2",
                           "model.router.differentiable_gan_term=false"])
        modules = build_tiny_moe(cfg, shape)
        state = init_state(modules, cfg, seed, dev)
        plain = build_train_step(modules, cfg)
        draws = draw_step_noise(torch.Generator(device=dev).manual_seed(seed + 3), modules, b,
                                dev, plain.switch)
        ref, ref_metrics = plain(state, batch, draws, 0)
        t = time.perf_counter()
        new, metrics = build_train_step(modules, cfg, mesh)(
            shard_state(mesh, state, N_EXPERTS), place_tree(batch_sharding(mesh), batch),
            draws, 0)
        whole = gather_state(mesh, new, N_EXPERTS)
        seconds = time.perf_counter() - t
        problems += [f"{dispatch}: {p}" for p in step_disagreement(
            whole, ref, metrics, ref_metrics, make_optimizers(cfg))]
        problems += [f"{dispatch}: {k} differs between ranks" for k in unequal_across_ranks(
            mesh, {**{f"metric {k}": v for k, v in metrics.items()}, **_flat(whole)})]
        out[dispatch] = {"gen_loss": float(metrics["gen_loss"]), "seconds": seconds}
    bad = torch.tensor([len(problems)], device=dev)
    import torch.distributed as dist

    dist.all_reduce(bad)
    if problems or int(bad.item()):
        raise RuntimeError(f"dryrun_multigpu FAILED on rank {mesh.rank}: "
                           f"{problems or 'another rank'}")
    return out


def serve_rank(rank: int, world: int, dev: torch.device, n_per_rank: int = 16) -> None:
    """The dry run's body on one rank (see the module doc)."""
    import torch.distributed as dist

    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.parallel.mesh import make_mesh, shard_state
    from zdcsim_torch.train.state import init_state

    t0 = time.perf_counter()
    mesh = make_mesh(expert_parallel=2 if world % 2 == 0 else 1,
                     device="cpu" if dev.type == "cpu" else None)
    n_data = mesh.shape["data"]
    trained = train_steps(mesh, dev, 4 * world)
    cfg = load_config([f"model.generator.width={WIDTH}", f"model.n_experts={N_EXPERTS}"])
    modules = build_moe(cfg)
    state = init_state(modules, cfg, SEED, dev)
    local = shard_state(mesh, state, N_EXPERTS)
    n = n_per_rank * world
    batch = 8 * n_data
    eng = FastSim.from_state(modules, local, cfg=cfg, batch_size=batch, mesh=mesh)
    cond = torch.randn((n, cfg.model.cond_dim), generator=torch.Generator().manual_seed(SEED + 1))
    gen = torch.Generator(device=dev)
    imgs, ids = eng.simulate_switch(cond, generator=gen.manual_seed(SEED + 2),
                                    return_experts=True)
    ref = FastSim.from_state(modules, state, cfg=cfg, batch_size=batch, device=dev)
    ref_imgs, ref_ids = ref.simulate_switch(cond, generator=gen.manual_seed(SEED + 2),
                                            return_experts=True)
    # every rank holds the same showers: rank 0's, broadcast, must equal each rank's
    first = imgs.clone()
    dist.broadcast(first, src=0)
    problems = []
    if tuple(imgs.shape) != (n, *eng.image_shape) or not bool(torch.isfinite(imgs).all()):
        problems.append(f"showers of shape {tuple(imgs.shape)}, finite "
                        f"{bool(torch.isfinite(imgs).all())}")
    if not torch.equal(first, imgs):
        problems.append("the showers differ between ranks")
    if not torch.equal(ids, ref_ids):
        problems.append("routing differs from the meshless engine")
    if not torch.allclose(imgs, ref_imgs, rtol=1e-5, atol=1e-6):
        problems.append(f"showers off the meshless engine by "
                        f"{(imgs - ref_imgs).abs().max().item():.3e}")
    bad = torch.tensor([len(problems)], device=dev)
    dist.all_reduce(bad)
    if problems or int(bad.item()):
        raise RuntimeError(f"dryrun_multigpu FAILED on rank {rank}: {problems or 'another rank'}")
    if rank == 0:
        routing = torch.bincount(ids.cpu(), minlength=N_EXPERTS).tolist()
        steps = ", ".join(f"{k} gen_loss {v['gen_loss']:.4f} in {v['seconds']:.2f}s"
                          for k, v in trained.items())
        print(f"dryrun_multigpu OK: mesh=(data={n_data}, expert={mesh.shape['expert']}) "
              f"world={world} device={dev.type} trained=[{steps}] on batch {4 * world}, "
              f"each step held against the meshless one; served={n} showers "
              f"{list(imgs.shape)} routing {routing} width={WIDTH} E={N_EXPERTS} "
              f"batch={batch} in {time.perf_counter() - t0:.2f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train steps and a sharded serve on a "
                                             "(data, expert) mesh")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default: the visible cards; 4 with --cpu)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        _rank_entry(int(os.environ["RANK"]), serve_rank, int(os.environ["WORLD_SIZE"]),
                    "env://", args.cpu, ())
        return 0
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun: no CUDA device is visible (pass --cpu for gloo ranks)", file=sys.stderr)
        return 2
    world = args.world or (4 if args.cpu else torch.cuda.device_count())
    if not args.cpu and world > torch.cuda.device_count():
        print(f"dryrun: --world {world} needs {world} cards, {torch.cuda.device_count()} "
              f"are visible", file=sys.stderr)
        return 2
    run_world(serve_rank, world, cpu=args.cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
