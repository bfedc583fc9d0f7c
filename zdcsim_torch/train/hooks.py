"""Training callbacks (counterpart of ``zdcsim/train/hooks.py``): the
``on_train_start / on_epoch_start / on_epoch_end / on_train_end`` surface,
a console line per epoch, a metrics history, a wandb logger, checkpoints
where ``ws_mean`` beats ``train.ws_threshold_model_save`` and the training
curves. A callback that fails is logged and the run goes on, as in JAX.

``wandb`` and ``matplotlib`` are imported only when a callback that needs
them is enabled; neither machine of this port has them.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)


class Callback:
    def on_train_start(self, cfg, state) -> None: ...

    def on_epoch_start(self, epoch: int) -> None: ...

    def on_epoch_end(self, epoch: int, metrics: Dict[str, Any], state) -> None: ...

    def on_train_end(self, history: List[Dict[str, Any]]) -> None: ...


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def _dispatch(self, method: str, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, method)(*args)
            except Exception:  # noqa: BLE001 — as JAX: log and go on
                log.warning("Callback %s.%s failed", type(cb).__name__, method, exc_info=True)

    def on_train_start(self, cfg, state):
        self._dispatch("on_train_start", cfg, state)

    def on_epoch_start(self, epoch):
        self._dispatch("on_epoch_start", epoch)

    def on_epoch_end(self, epoch, metrics, state):
        self._dispatch("on_epoch_end", epoch, metrics, state)

    def on_train_end(self, history):
        self._dispatch("on_train_end", history)


class ConsoleLogger(Callback):
    """Per-epoch log line of the headline metrics."""

    def __init__(self):
        self._t0 = None

    def on_epoch_start(self, epoch):
        self._t0 = time.time()

    def on_epoch_end(self, epoch, metrics, state):
        dt = time.time() - self._t0 if self._t0 else float("nan")
        parts = [f"epoch {epoch} ({dt:.1f}s)"]
        for k in ("gen_loss", "disc_loss", "router_loss", "ws_mean"):
            if k in metrics and metrics[k] is not None:
                parts.append(f"{k}={float(metrics[k]):.4f}")
        log.info(" ".join(parts))


class MetricsTracker(Callback):
    """History of the epochs' metrics with a best-metric query."""

    def __init__(self):
        self.history: List[Dict[str, Any]] = []

    def on_epoch_end(self, epoch, metrics, state):
        self.history.append(
            {"epoch": epoch, **{k: v for k, v in metrics.items() if not k.startswith("_")}}
        )

    def best(self, key: str = "ws_mean", mode: str = "min") -> Optional[Dict[str, Any]]:
        rows = [h for h in self.history if h.get(key) is not None]
        if not rows:
            return None
        pick = min if mode == "min" else max
        return pick(rows, key=lambda h: h[key])


class WandBLogger(Callback):
    """wandb epoch logging with a flattened config, the eval figures
    (``_figures``) as ``wandb.Image``; a no-op (with a warning) where wandb
    is not installed or ``wandb.log_experiments`` is off."""

    def __init__(self, cfg):
        self.enabled = bool(cfg.wandb.log_experiments)
        self.run = None

    def on_train_start(self, cfg, state):
        if not self.enabled:
            return
        try:
            import wandb
        except ImportError:
            log.warning("wandb.log_experiments=true but wandb is not installed; disabling")
            self.enabled = False
            return
        import dataclasses

        self.run = wandb.init(
            project=getattr(cfg.wandb, "project", "zdcsim"),
            entity=getattr(cfg.wandb, "entity", None) or None,
            name=cfg.wandb.run_name or cfg.config.run_name,
            config=_flatten(dataclasses.asdict(cfg)),
        )

    def on_epoch_end(self, epoch, metrics, state):
        if self.run is not None:
            import wandb

            loggable = {
                k: v for k, v in metrics.items()
                if isinstance(v, (int, float, np.floating, np.integer)) and v is not None
            }
            for name, fig in (metrics.get("_figures") or {}).items():
                loggable[name] = wandb.Image(fig)
            self.run.log({"epoch": epoch, **loggable})

    def on_train_end(self, history):
        if self.run is not None:
            self.run.finish()


class CheckpointSaver(Callback):
    """Save the whole train state where ``ws_mean`` is below the threshold.

    ``keep_best`` keeps only the k checkpoints of lowest ``ws_mean`` (the
    worst is deleted as a better one lands, after the write in flight has
    finished); ``use_async`` writes in a background thread
    (``zdcsim_torch.train.checkpoint.AsyncSaver``). Without ``dir_models``
    (no ``train.save_experiment_data``) it saves nothing.
    """

    def __init__(
        self,
        dir_models: Optional[str],
        ws_threshold: float,
        keep_best: Optional[int] = None,
        use_async: bool = False,
    ):
        self.dir_models = dir_models
        self.ws_threshold = float(ws_threshold)
        self.keep_best = int(keep_best) if keep_best else None
        self.saved_epochs: List[int] = []
        self._saved_ws: List[tuple] = []  # (ws, epoch) of the checkpoints on disk
        self._async = None
        if use_async and dir_models is not None:
            from zdcsim_torch.train.checkpoint import AsyncSaver

            self._async = AsyncSaver()

    def on_epoch_end(self, epoch, metrics, state):
        if self.dir_models is None:
            return
        ws = metrics.get("ws_mean")
        if ws is None or float(ws) >= self.ws_threshold:
            return
        from zdcsim_torch.train.checkpoint import delete_checkpoint, save_checkpoint

        if self._async is not None:
            path = self._async.save(self.dir_models, epoch, state)
        else:
            path = save_checkpoint(self.dir_models, epoch, state)
        self.saved_epochs.append(epoch)
        self._saved_ws.append((float(ws), epoch))
        log.info("Saved checkpoint (ws_mean=%.3f < %.1f)%s: %s", ws, self.ws_threshold,
                 " [async]" if self._async else "", path)
        if self.keep_best is not None and len(self._saved_ws) > self.keep_best:
            worst = max(self._saved_ws, key=lambda t: t[0])
            self._saved_ws.remove(worst)
            if self._async is not None:
                self._async.wait()  # never delete under a write in flight
            delete_checkpoint(self.dir_models, worst[1])
            log.info("Dropped checkpoint epoch %d (ws=%.3f, keep_best=%d)",
                     worst[1], worst[0], self.keep_best)

    def on_train_end(self, history):
        if self._async is not None:
            self._async.close()


class TrainingCurvePlotter(Callback):
    """Loss and WS curves against the epoch, saved as a PNG at train end
    (``matplotlib`` imported only then)."""

    def __init__(self, out_dir: Optional[str], enabled: bool):
        self.out_dir = out_dir
        self.enabled = enabled and out_dir is not None

    def on_train_end(self, history):
        if not self.enabled or not history:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(16, 4))
        epochs = [h["epoch"] for h in history]
        for ax, keys, title in (
            (axes[0], ("gen_loss", "disc_loss"), "GAN losses"),
            (axes[1], ("div_loss", "intensity_loss", "aux_reg_loss"), "Regularizers"),
            (axes[2], ("ws_mean",), "Wasserstein fidelity"),
        ):
            for k in keys:
                xs = [e for e, h in zip(epochs, history) if h.get(k) is not None]
                ys = [h[k] for h in history if h.get(k) is not None]
                if xs:
                    ax.plot(xs, ys, label=k)
            ax.set_xlabel("epoch")
            ax.set_title(title)
            ax.legend()
        if any(h.get("ws_mean") for h in history):
            axes[2].set_yscale("log")
        fig.tight_layout()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "training_curves.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        log.info("Saved training curves to %s", path)


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def setup_callbacks(cfg, dir_models: Optional[str]) -> CallbackList:
    """Console, history, wandb, checkpoints and the training curves, as
    ``zdcsim/train/hooks.py:setup_callbacks``."""
    plots_enabled = bool(cfg.wandb.plot_images) or bool(cfg.train.save_eval_plots)
    plots_dir = os.path.join(str(cfg.config.experiment_dir or "."), "plots")
    return CallbackList([
        ConsoleLogger(),
        MetricsTracker(),
        WandBLogger(cfg),
        CheckpointSaver(
            dir_models,
            cfg.train.ws_threshold_model_save,
            keep_best=cfg.train.checkpoint_keep_best,
            use_async=bool(cfg.train.async_checkpointing),
        ),
        TrainingCurvePlotter(plots_dir, plots_enabled),
    ])
