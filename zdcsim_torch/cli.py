"""Command-line entry point of the port (counterpart of ``zdcsim/cli.py``):
``python cli_torch.py --override key=value ...`` trains; ``--bench`` times
the serving engine, ``--simulate OUT.npz`` serves the test split to a file,
``--eval`` prints the evaluator's metrics as JSON; each of the three from
``--checkpoint-epoch`` of ``train.checkpoint_experiment_dir`` where given.

It runs on CUDA unless ``--cpu`` is given, and raises where no card is
visible. Training on a ``(data, expert)`` mesh runs one process a card
under ``torchrun``, which the CLI joins to its world (``env://``; gloo with
``--cpu``)::

    torchrun --nproc-per-node 4 cli_torch.py --override parallel.n_devices=4 \
        parallel.expert_parallel=2 ... ``--config`` names a YAML file merged over the defaults
(``zdcsim_torch.config.read_yaml``: the subset of YAML the configs use, no
PyYAML), e.g. the neutron preset ``zdcsim/config/neutron.yaml``; then
``--override`` applies.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

log = logging.getLogger("zdcsim_torch")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="zdcsim_torch",
                                description="ZDC fast simulation on PyTorch + CUDA")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config merged over the defaults (e.g. zdcsim/config/neutron.yaml)")
    p.add_argument(
        "--override", nargs="*", default=[], metavar="KEY=VALUE",
        help="dotlist overrides, e.g. model.n_experts=5 train.epochs=10",
    )
    p.add_argument("--bench", action="store_true", help="run the fast-sim throughput benchmark")
    p.add_argument("--simulate", type=str, default=None, metavar="OUT.npz",
                   help="run fast-sim inference on the test split and save showers")
    p.add_argument("--eval", action="store_true",
                   help="run the WS evaluation on the test split (optionally from "
                        "--checkpoint-epoch) and print the metrics as JSON")
    p.add_argument("--checkpoint-epoch", type=int, default=None,
                   help="with --bench/--simulate/--eval: load this checkpoint epoch")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise where a backward "
                        "produces NaN (the reference's switch)")
    return p.parse_args(argv)


def _inject_checkpoint_epoch(overrides: List[str], checkpoint_epoch: Optional[int]) -> List[str]:
    """``--checkpoint-epoch`` as ``train.epoch_to_load`` (unless the
    overrides set it), so the data split is the saved run's (its indices
    read back), not one drawn anew from the seed."""
    out = list(overrides)
    if checkpoint_epoch is not None and not any(
        o.startswith("train.epoch_to_load=") for o in out
    ):
        out.append(f"train.epoch_to_load={checkpoint_epoch}")
    return out


def _state(cfg, modules, device, checkpoint_epoch: Optional[int]):
    """A fresh state from ``train.seed``, or the checkpoint of
    ``checkpoint_epoch`` restored into a template of the state."""
    from zdcsim_torch.train.state import init_state

    state = init_state(modules, cfg, None if checkpoint_epoch is not None else
                       int(cfg.train.seed), device)
    if checkpoint_epoch is not None:
        from zdcsim_torch.train.checkpoint import restore_checkpoint

        state = restore_checkpoint(_models_dir(cfg), checkpoint_epoch, state)
    return state


def _models_dir(cfg) -> str:
    from zdcsim_torch.utils.io import DIR_MODELS

    if cfg.train.checkpoint_experiment_dir is None:
        raise SystemExit("--checkpoint-epoch requires train.checkpoint_experiment_dir")
    return DIR_MODELS.format(EXPERIMENT_DIR_NAME=cfg.train.checkpoint_experiment_dir)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    args = parse_args(argv)

    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.device import default_device

    cfg = load_config(_inject_checkpoint_epoch(args.override, args.checkpoint_epoch),
                      config_path=args.config)
    device = default_device("cpu" if args.cpu else None)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    log.info("torch %s, device %s", torch.__version__,
             torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")

    if args.bench:
        from zdcsim_torch.inference.engine import FastSim
        from zdcsim_torch.models import build_moe

        if args.checkpoint_epoch is not None:
            engine = FastSim.from_checkpoint(cfg, _models_dir(cfg), args.checkpoint_epoch,
                                             device=device)
        else:
            modules = build_moe(cfg)
            engine = FastSim.from_state(modules, _state(cfg, modules, device, None), cfg=cfg,
                                        device=device)
        print(json.dumps(engine.throughput()))
        return 0

    if args.eval or args.simulate is not None:
        from zdcsim_torch.data.dataset import get_train_test_data
        from zdcsim_torch.models import build_moe
        from zdcsim_torch.utils.io import append_experiment_dir_to_cfg

        append_experiment_dir_to_cfg(cfg)
        split = get_train_test_data(cfg)
        modules = build_moe(cfg)
        state = _state(cfg, modules, device, args.checkpoint_epoch)

    if args.eval:
        from zdcsim_torch.data.loader import make_loaders
        from zdcsim_torch.train.evaluate import build_evaluator

        _, test_loader = make_loaders(cfg, split, device)
        metrics = build_evaluator(modules, cfg)(
            state, test_loader.arrays, args.checkpoint_epoch or 0,
            torch.Generator(device=device).manual_seed(0))
        print(json.dumps({
            k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in metrics.items()
        }))
        return 0

    if args.simulate is not None:
        from zdcsim_torch.inference.engine import FastSim

        # the tiled switch dispatch: one expert's work a shower, in chunks
        # of 4096 (JAX's), or one chunk of a smaller test side
        engine = FastSim.from_state(modules, state, cfg=cfg, scaler_cond=split.scaler_cond,
                                    batch_size=min(4096, len(split.y_test)), device=device)
        showers, experts = engine.simulate_switch(
            split.y_test, generator=torch.Generator(device=device).manual_seed(0),
            return_experts=True)
        np.savez(args.simulate, showers=showers.cpu().numpy(),
                 experts=experts.cpu().numpy().astype(np.int32))  # JAX's argmax dtype
        log.info("Wrote %d showers to %s", showers.shape[0], args.simulate)
        return 0

    from zdcsim_torch.train.loop import train

    world = "RANK" in os.environ and "WORLD_SIZE" in os.environ  # started by torchrun
    if world:
        from zdcsim_torch.parallel.mesh import init_world

        init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                   "cpu" if args.cpu else None)
    try:
        history = train(cfg, device=device)
    except Exception:
        log.exception("Training failed")
        return 1
    finally:
        if world:
            import torch.distributed as dist

            dist.destroy_process_group()
    if history:
        last = history[-1]
        log.info("Final epoch metrics: %s",
                 {k: v for k, v in last.items() if not k.startswith("_")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
