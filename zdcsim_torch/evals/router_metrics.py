"""Router classification metrics against precomputed expert labels (the
port's own copy of ``zdcsim/evals/router_metrics.py``, numpy).

The router's argmax assignment scored against the dataset's
``expert_number``: accuracy and the macro-averaged precision, recall and F1
over the experts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def router_classification_metrics(
    predicted: np.ndarray, labels: np.ndarray, n_experts: int
) -> Dict[str, float]:
    predicted = np.asarray(predicted).astype(np.int64)
    labels = np.asarray(labels).astype(np.int64)
    accuracy = float((predicted == labels).mean()) if predicted.size else 0.0

    precisions, recalls, f1s = [], [], []
    for e in range(n_experts):
        tp = int(np.sum((predicted == e) & (labels == e)))
        fp = int(np.sum((predicted == e) & (labels != e)))
        fn = int(np.sum((predicted != e) & (labels == e)))
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        precisions.append(p)
        recalls.append(r)
        f1s.append(f)
    return {
        "accuracy": accuracy,
        "precision": float(np.mean(precisions)),
        "recall": float(np.mean(recalls)),
        "f1": float(np.mean(f1s)),
    }
