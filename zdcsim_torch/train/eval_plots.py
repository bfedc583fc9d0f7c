"""The eval epochs' diagnostic figures (counterpart of
``zdcsim/train/eval_plots.py``): routed sample grids, per-expert photon-sum
histograms, the expert-specialisation and heatmap panels and the PCA/t-SNE
projection, made every eval epoch with ``wandb.plot_images`` or
``train.save_eval_plots``.

Two halves. :func:`figure_arrays` runs once on the state's device: the
router's argmax of the first ``max_samples`` test conditions, the routed
generation in eval (no dropout, BatchNorm on the running statistics, as
``zdcsim_torch/train/evaluate.py``), ``torch.expm1`` of the generated and
the real showers, and one copy to the host. A fault there propagates.
:func:`build_figures` then draws on the host with
``zdcsim_torch.evals.plots`` (matplotlib, imported only there).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from zdcsim_torch.models import MoEModules
from zdcsim_torch.train.evaluate import expert_trees, routed_decode
from zdcsim_torch.train.step import f32_matmuls

log = logging.getLogger(__name__)


def require_matplotlib() -> None:
    """Raise ``ImportError`` now, where the figures are on and this host has
    no matplotlib (the loop calls it before its first step)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("wandb.plot_images / train.save_eval_plots draw with matplotlib, "
                          "which this host lacks; turn them off") from e


@torch.no_grad()
def figure_arrays(modules: MoEModules, state, test_arrays: Dict[str, object],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  max_samples: int = 512) -> Dict[str, np.ndarray]:
    """The device half: ``{"generated", "real"}`` linear-space showers
    ``[n, H, W]``, ``"experts"`` the routed expert ``[n]`` and ``"cond"``
    ``[n, C]`` on the host, ``n = min(max_samples, N)``. ``noise [n,
    noise_dim]`` is drawn from ``generator`` unless given."""
    dev = next(iter(state.router.params.values())).device
    cond = torch.as_tensor(test_arrays["cond"][:max_samples]).to(dev, torch.float32)
    real = torch.as_tensor(test_arrays["real"][:max_samples]).to(dev, torch.float32)
    if real.ndim == 4:
        real = real[..., 0]
    n = cond.shape[0]
    if noise is None:
        noise = torch.randn((n, modules.noise_dim), generator=generator, device=dev)
    noise = torch.as_tensor(noise).to(dev, torch.float32)
    with f32_matmuls():
        idx = torch.argmax(modules.route(state.router.params, cond), dim=-1)
        experts = expert_trees(state.gen.params, state.gen.stats, modules.n_experts)
        gen = routed_decode(modules, state.gen.params, state.gen.stats, experts, cond, idx,
                            noise)
    parts = (torch.expm1(gen), torch.expm1(real), idx.to(torch.float32), cond)
    host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()  # the one copy
    out, at = {}, 0
    for name, p in zip(("generated", "real", "experts", "cond"), parts):
        out[name] = host[at: at + p.numel()].reshape(tuple(p.shape))
        at += p.numel()
    out["experts"] = out["experts"].astype(np.int64)
    return out


def build_figures(arrays: Dict[str, np.ndarray], epoch: int, cond_names: Sequence[str],
                  n_experts: int, title: str = "") -> Dict[str, object]:
    """The host half: JAX's figures of :func:`figure_arrays`' arrays."""
    from zdcsim_torch.evals.plots import (
        plot_cond_pca_tsne, plot_expert_heatmap, plot_expert_specialization,
        plot_photonsum_histograms_shared, plot_real_vs_generated,
    )

    gen_lin, real_lin = arrays["generated"], arrays["real"]
    idx_np, cond_np = arrays["experts"], arrays["cond"]
    n = cond_np.shape[0]
    routed = [e for e in range(n_experts) if (idx_np == e).any()]
    figures = {
        "real_vs_generated": plot_real_vs_generated(real_lin, gen_lin, epoch, title=title),
        "photonsum_histograms": plot_photonsum_histograms_shared(
            [gen_lin[idx_np == e].reshape((idx_np == e).sum(), -1).sum(axis=1) for e in routed]
            + [real_lin.reshape(n, -1).sum(axis=1)],
            labels=[f"Expert {e}" for e in routed] + ["GEANT4"],
        ),
        "expert_specialization": plot_expert_specialization(cond_np, idx_np, epoch, cond_names),
        "expert_heatmap": plot_expert_heatmap(cond_np, idx_np, epoch, cond_names),
    }
    # t-SNE needs more than one routed expert and a handful of samples
    if len(np.unique(idx_np)) > 1 and n >= 16:
        try:
            figures["cond_pca_tsne"] = plot_cond_pca_tsne(cond_np, idx_np, epoch)
        except Exception:  # noqa: BLE001 — as JAX: the other figures stand
            log.warning("PCA/t-SNE figure failed", exc_info=True)
    return figures


def generate_eval_figures(modules: MoEModules, state, test_arrays: Dict[str, object],
                          epoch: int, cond_names: Sequence[str],
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None,
                          max_samples: int = 512) -> Dict[str, object]:
    """Route and generate a sample of the test side, and draw the figures."""
    arrays = figure_arrays(modules, state, test_arrays, generator, noise, max_samples)
    return build_figures(arrays, epoch, cond_names, modules.n_experts,
                         title=modules.names.get("generator", ""))


def save_figures(figures: Dict[str, object], out_dir: str, epoch: int) -> None:
    """Each figure as ``<out_dir>/<name>_epoch_<epoch>.png``."""
    os.makedirs(out_dir, exist_ok=True)
    for name, fig in figures.items():
        fig.savefig(os.path.join(out_dir, f"{name}_epoch_{epoch}.png"), dpi=110)
    log.info("Saved %d eval figures to %s", len(figures), out_dir)
