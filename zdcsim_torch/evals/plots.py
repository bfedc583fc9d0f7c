"""Diagnostic figures (counterpart of ``zdcsim/evals/plots.py``): numpy
arrays in, a matplotlib Figure out (the caller saves it or logs it to
wandb), on the non-interactive Agg backend.

``matplotlib``, ``scipy.stats`` and ``sklearn`` are imported inside the
functions that draw, so importing this module pulls in none of them (the GPU
machine has no matplotlib or sklearn).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_real_vs_generated(real: np.ndarray, generated: np.ndarray, epoch: int,
                           title: str = "", k: int = 6):
    """Top row: ``k`` real showers; bottom row: ``k`` generated (linear
    space)."""
    plt = _pyplot()
    fig, axs = plt.subplots(2, k, figsize=(15, 5))
    fig.suptitle(f"{title}\nEPOCH: {epoch}", x=0.1, horizontalalignment="left")
    for i in range(2 * k):
        x = real[i] if i < k else generated[i - k]
        ax = axs[i // k, i % k]
        im = ax.imshow(np.asarray(x), cmap="gnuplot")
        ax.axis("off")
        fig.colorbar(im, ax=ax)
    fig.tight_layout(rect=[0, 0, 1, 0.975])
    plt.close(fig)
    return fig


def plot_photonsum_histograms_shared(datasets: Sequence[np.ndarray],
                                     labels: Optional[Sequence[str]] = None):
    """Log-scale step histograms of per-expert photon sums on 50 bins shared
    by all of them."""
    datasets = [np.asarray(d).ravel() for d in datasets if np.asarray(d).size]
    if not datasets:
        raise ValueError("need at least one non-empty dataset")
    if labels is not None and len(labels) != len(datasets):
        raise ValueError("labels must match datasets")
    plt = _pyplot()
    all_data = np.concatenate(datasets)
    bins = np.linspace(all_data.min(), all_data.max(), 51)
    fig, ax = plt.subplots(figsize=(10, 10))
    for i, data in enumerate(datasets):
        hist, _ = np.histogram(data, bins=bins)
        ax.step(bins[:-1], hist, where="post", label=labels[i] if labels else f"Expert {i}")
    ax.set_yscale("log")
    ax.set_xlabel("Photon Sum")
    ax.set_ylabel("Frequency")
    ax.set_title("Photon-sum distribution per expert")
    ax.legend()
    fig.tight_layout()
    plt.close(fig)
    return fig


def plot_expert_specialization(cond: np.ndarray, expert_idx: np.ndarray, epoch: int,
                               cond_names: Sequence[str]):
    """3x3 panels of each expert's KDE over each conditioning variable; the
    last variable is categorical (grouped log-scale bars of its values)."""
    from scipy import stats as sstats

    plt = _pyplot()
    cond = np.asarray(cond)
    n_experts = int(expert_idx.max()) + 1 if expert_idx.size else 1
    fig, axes = plt.subplots(3, 3, figsize=(18, 12))
    fig.suptitle(f"Expert Specialization on Input Data - Epoch {epoch}", fontsize=16)
    for var_idx, name in enumerate(cond_names[:9]):
        ax = axes[var_idx // 3, var_idx % 3]
        col = cond[:, var_idx]
        if var_idx == len(cond_names) - 1:  # categorical (charge)
            uniq = np.unique(col)
            x = np.arange(len(uniq))
            width = 0.8 / max(n_experts, 1)
            for e in range(n_experts):
                vals = col[expert_idx == e]
                counts = [int(np.sum(vals == u)) for u in uniq]
                ax.bar(x + (e - n_experts / 2) * width, counts, width, label=f"Expert {e+1}")
            ax.set_yscale("log")
            ax.set_xticks(x)
            ax.set_xticklabels([f"{u:.2g}" for u in uniq])
            ax.set_title(f"{name} (Categorical)")
        else:
            lo, hi = float(col.min()), float(col.max())
            if lo == hi:
                lo, hi = lo - 1e-6, hi + 1e-6
            xs = np.linspace(lo, hi, 100)
            for e in range(n_experts):
                vals = col[expert_idx == e]
                vals = vals[np.isfinite(vals)]
                if vals.size < 5 or np.std(vals) < 1e-12:
                    continue
                try:
                    kde = sstats.gaussian_kde(vals, bw_method="scott")
                    ax.plot(xs, kde(xs), label=f"Expert {e+1}")
                except np.linalg.LinAlgError:
                    continue
            ax.set_title(name)
        if ax.get_legend_handles_labels()[1]:
            ax.legend(loc="upper right", fontsize="x-small")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    plt.close(fig)
    return fig


def plot_expert_heatmap(cond: np.ndarray, expert_idx: np.ndarray, epoch: int,
                        cond_names: Sequence[str], num_bins: int = 50):
    """Per conditioning variable, an (expert x value bin) heatmap of sample
    counts."""
    plt = _pyplot()
    cond = np.asarray(cond)
    n_experts = int(expert_idx.max()) + 1 if expert_idx.size else 1
    fig, axes = plt.subplots(3, 3, figsize=(18, 12))
    fig.suptitle(f"Sample Distribution Across Experts and Bins — Epoch {epoch}", fontsize=16)
    for var_idx, name in enumerate(cond_names[:9]):
        ax = axes[var_idx // 3, var_idx % 3]
        col = cond[:, var_idx]
        bins = np.linspace(col.min(), col.max() + 1e-9, num_bins + 1)
        grid = np.zeros((n_experts, num_bins))
        for e in range(n_experts):
            grid[e], _ = np.histogram(col[expert_idx == e], bins=bins)
        ax.imshow(grid, aspect="auto", cmap="Blues")
        ax.set_yticks(range(n_experts))
        ax.set_yticklabels([f"E{e+1}" for e in range(n_experts)])
        ax.set_title(name)
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    plt.close(fig)
    return fig


def plot_cond_pca_tsne(cond: np.ndarray, expert_idx: np.ndarray, epoch: int,
                       max_tsne: int = 2000):
    """PCA and t-SNE 2-D projections of the conditioning set coloured by the
    routed expert; t-SNE on a ``default_rng(42)`` subsample of ``max_tsne``
    rows, ``random_state=42``."""
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE

    plt = _pyplot()
    cond = np.asarray(cond)
    labels = np.asarray(expert_idx)
    y_pca = PCA(n_components=2).fit_transform(cond)

    sub = np.random.default_rng(42).permutation(cond.shape[0])[:max_tsne]
    y_tsne = TSNE(n_components=2, random_state=42,
                  perplexity=min(30, max(5, len(sub) // 4))).fit_transform(cond[sub])

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    fig.suptitle(f"EPOCH: {epoch}", x=0.1, horizontalalignment="left")
    for ax, (pts, lab, title) in zip(
        axes, [(y_pca, labels, "PCA Projection"), (y_tsne, labels[sub], "t-SNE Projection")],
    ):
        sc = ax.scatter(pts[:, 0], pts[:, 1], c=lab, cmap="viridis", s=10)
        ax.set_title(title)
        legend = ax.legend(*sc.legend_elements(), title="Experts")
        ax.add_artist(legend)
    plt.close(fig)
    return fig
