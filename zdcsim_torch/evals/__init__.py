"""Evaluation extras: router metrics, image statistics, the dataset report
and the diagnostic figures (``zdcsim/evals``'s public names).

The names resolve on first use, so importing the package pulls in no
plotting library (``plots`` imports matplotlib only when it draws).
"""

_NAMES = {
    "image_feature_stats": "stats",
    "router_classification_metrics": "router_metrics",
    "dataset_analysis_report": "report",
    "plot_cond_pca_tsne": "plots",
    "plot_expert_heatmap": "plots",
    "plot_expert_specialization": "plots",
    "plot_photonsum_histograms_shared": "plots",
    "plot_real_vs_generated": "plots",
}
__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
