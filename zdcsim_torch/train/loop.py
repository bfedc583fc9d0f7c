"""The training loop (counterpart of ``zdcsim/train/loop.py``).

Per epoch: each batch of the train loader (``DeviceLoader``) goes through
the train step (``zdcsim_torch/train/step.py``, dense or switch) with that
(epoch, batch)'s draws (``zdcsim_torch.utils.prng.fold_epoch_batch``); the
step's metrics add up on the device and reach the host once an epoch
(:func:`_finalize_metrics`). Every ``train.eval_every`` epochs, and at the
last, the evaluator (``zdcsim_torch/train/evaluate.py``) scores the state on
the test side with the epoch's eval draws; then the callbacks
(``zdcsim_torch/train/hooks.py``) log and checkpoint. A resume
(``train.checkpoint_experiment_dir`` with ``train.epoch_to_load``) restores
that epoch's checkpoint and trains from that epoch on, that epoch included,
as JAX does. ``train.profile_epoch`` traces one epoch's steps with
``torch.profiler``.

With ``wandb.plot_images`` or ``train.save_eval_plots`` each eval epoch
also draws the diagnostic figures (``zdcsim_torch/train/eval_plots.py``)
from a stream of their own (``zdcsim_torch.utils.prng.figure_generator``)
and saves them under ``<experiment_dir>/plots``; without matplotlib on the
host the loop raises before its first step. A fault of the figures' device
half propagates; one of the host's drawing is logged and the run goes on,
as in JAX.

The loop runs on CUDA unless the caller passes ``device="cpu"``. What it
does not port raises ``NotImplementedError`` naming its ``ROADMAP.md``
item: more than one device.

Each epoch also logs the seconds of its steps (to the card's end of
them), of the metrics' one host copy, of the evaluation and of the callbacks (the checkpoint write's host
copy, and its disk write unless that runs in the background), as
``epoch <n> time split: {...}``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch

from zdcsim_torch.data.dataset import get_train_test_data
from zdcsim_torch.data.loader import make_loaders
from zdcsim_torch.device import default_device
from zdcsim_torch.models import build_moe, model_info
from zdcsim_torch.train.evaluate import build_evaluator
from zdcsim_torch.train.hooks import setup_callbacks
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise
from zdcsim_torch.utils.io import DIR_MODELS, append_experiment_dir_to_cfg
from zdcsim_torch.utils.prng import eval_generator, figure_generator, fold_epoch_batch
from zdcsim_torch.utils.profiling import trace

log = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")


def check_loop_options(cfg) -> None:
    """Raise ``NotImplementedError`` for each loop option not ported."""
    if cfg.parallel.n_devices is not None and int(cfg.parallel.n_devices) > 1:
        raise _not_ported(f"parallel.n_devices={cfg.parallel.n_devices} (multi-GPU)", "8")
    if int(cfg.parallel.expert_parallel) > 1:
        raise _not_ported(f"parallel.expert_parallel={cfg.parallel.expert_parallel}", "8")


def _accumulate(acc: Optional[Metrics], new: Metrics) -> Metrics:
    if acc is None:
        return dict(new)
    return {k: acc[k] + v for k, v in new.items()}


def _finalize_metrics(acc: Metrics, n_batches: int) -> Dict[str, Any]:
    """Device sums -> host floats, in one copy; the per-expert vectors
    (``*_experts`` and the routing shares) expand to ``_i`` keys."""
    keys = list(acc)
    flat = torch.cat([acc[k].reshape(-1).to(torch.float32) for k in keys]).cpu().numpy()
    out: Dict[str, Any] = {}
    at = 0
    for k in keys:
        size = acc[k].numel()
        v = flat[at: at + size].reshape(acc[k].shape) / n_batches
        at += size
        if v.ndim == 0:
            out[k] = float(v)
        else:
            base = k[: -len("_experts")] if k.endswith("_experts") else k
            for i, x in enumerate(v):
                out[f"{base}_{i}"] = float(x)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, split=None, modules=None, return_state: bool = False,
          device: str | torch.device | None = None):
    """The whole run; returns the per-epoch history (with ``return_state``,
    ``(history, state)``). ``split`` and ``modules`` replace the config's
    (the tests pass tiny modules)."""
    dev = default_device(device)
    check_loop_options(cfg)
    plot_images = bool(cfg.wandb.plot_images) or bool(cfg.train.save_eval_plots)
    if plot_images:
        from zdcsim_torch.train import eval_plots

        eval_plots.require_matplotlib()
    if cfg.config.experiment_dir is None:
        append_experiment_dir_to_cfg(cfg)
    if split is None:
        split = get_train_test_data(cfg)
    if modules is None:
        modules = build_moe(cfg)
    seed = int(cfg.train.seed)
    state = init_state(modules, cfg, seed, dev)

    start_epoch = 0
    if cfg.train.checkpoint_experiment_dir is not None and cfg.train.epoch_to_load is not None:
        from zdcsim_torch.train.checkpoint import restore_checkpoint

        ckpt_models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=cfg.train.checkpoint_experiment_dir)
        state = restore_checkpoint(ckpt_models, int(cfg.train.epoch_to_load), state)
        start_epoch = int(cfg.train.epoch_to_load)
        log.info("Resumed from %s epoch %d", ckpt_models, start_epoch)

    train_loader, test_loader = make_loaders(cfg, split, dev)
    train_step = build_train_step(modules, cfg)
    evaluator = build_evaluator(modules, cfg)
    callbacks = setup_callbacks(cfg, split.dir_models)
    eval_every = int(cfg.train.eval_every)
    batch_size = int(cfg.train.batch_size)

    log.info("\n%s", model_info(modules, state))
    callbacks.on_train_start(cfg, state)
    history: List[Dict[str, Any]] = []
    epochs = int(cfg.train.epochs)
    profile_epoch = cfg.train.profile_epoch
    profile_dir = cfg.train.profile_dir or os.path.join(str(cfg.config.experiment_dir), "traces")
    try:
        for epoch in range(start_epoch, epochs):
            callbacks.on_epoch_start(epoch)
            t0 = time.time()
            acc, n_batches = None, 0
            with trace(profile_dir if profile_epoch == epoch else None):
                for b, batch in enumerate(train_loader.epoch(epoch)):
                    draws = draw_step_noise(fold_epoch_batch(seed, epoch, b, dev), modules,
                                            batch_size, dev, train_step.switch)
                    state, metrics = train_step(state, batch, draws, epoch)
                    acc = _accumulate(acc, metrics)
                    n_batches += 1
            _sync(dev)  # the steps' time is the card's, not the launches'
            t_steps = time.time()
            epoch_metrics = _finalize_metrics(acc, n_batches)
            t_sync = time.time()
            epoch_metrics["epoch_time"] = t_sync - t0

            if eval_every and (epoch % eval_every == 0 or epoch == epochs - 1):
                ws = evaluator(state, test_loader.arrays, epoch, eval_generator(seed, epoch, dev),
                               expert_labels=split.expert_number_test)
                epoch_metrics["ws_mean"] = ws["ws_mean"]
                epoch_metrics["ws_std"] = ws["ws_std"]
                for i in range(modules.n_experts):
                    epoch_metrics[f"ws_mean_{i}"] = float(ws["ws_mean_exp"][i])
                    epoch_metrics[f"ws_std_{i}"] = float(ws["ws_std_exp"][i])
                for k in ("router_accuracy", "router_precision", "router_recall", "router_f1"):
                    if k in ws:
                        epoch_metrics[k] = ws[k]
                if plot_images:
                    arrays = eval_plots.figure_arrays(modules, state, test_loader.arrays,
                                                      figure_generator(seed, epoch, dev))
                    try:
                        figs = eval_plots.build_figures(
                            arrays, epoch, split.data_cond_names, modules.n_experts,
                            title=modules.names.get("generator", ""))
                        eval_plots.save_figures(
                            figs, os.path.join(str(cfg.config.experiment_dir), "plots"), epoch)
                        epoch_metrics["_figures"] = figs
                    except Exception:  # noqa: BLE001 — as JAX: the host's drawing only
                        log.warning("Eval figure generation failed", exc_info=True)
            t_eval = time.time()

            history.append(
                {"epoch": epoch, **{k: v for k, v in epoch_metrics.items() if not k.startswith("_")}}
            )
            callbacks.on_epoch_end(epoch, epoch_metrics, state)
            times = {"steps": t_steps - t0, "sync": t_sync - t_steps, "eval": t_eval - t_sync,
                     "callbacks": time.time() - t_eval}
            log.info("epoch %d time split: %s", epoch, times)
    except Exception:
        log.exception("Training failed at epoch loop")
        raise
    finally:
        callbacks.on_train_end(history)
    if return_state:
        return history, state
    return history

