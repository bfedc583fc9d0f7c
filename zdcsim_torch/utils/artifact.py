"""Reader of the committed serving-weight artifacts (``artifacts/gate/*.npz``).

Own copy of the numpy codec of ``zdcsim/utils/artifact.py`` (the port may
not import ``zdcsim``). Float leaves at or above 65536 elements are stored
int8 with per-output-channel float16 scales under ``<key>::scale``; smaller
float leaves are float16; provenance strings sit under ``__meta__:<name>``.
Loading upcasts every float leaf to float32, bit-equal to the JAX loader.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np

_GROUPS = ("gen_params", "gen_stats", "router_params")
_META_PREFIX = "__meta__:"
_SCALE_SUFFIX = "::scale"
_SEP = "|"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested mapping -> ``{"a|b|c": leaf}``."""
    out: Dict[str, Any] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} contains reserved separator {_SEP!r}")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_serving_artifact(path: str) -> Tuple[Any, Any, Any, Dict[str, str]]:
    """Returns ``(gen_params, gen_stats, router_params, meta)``: nested dicts
    of float32 numpy arrays in the Flax layout (experts stacked on a leading
    axis), and the ``__meta__`` strings."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {
        k[len(_META_PREFIX):]: str(v)
        for k, v in flat.items() if k.startswith(_META_PREFIX)
    }
    groups: Dict[str, Dict[str, np.ndarray]] = {g: {} for g in _GROUPS}
    for key, value in flat.items():
        if key.startswith(_META_PREFIX) or key.endswith(_SCALE_SUFFIX):
            continue
        group, _, rest = key.partition(_SEP)
        if value.dtype == np.int8:
            scale = flat[f"{key}{_SCALE_SUFFIX}"].astype(np.float32)
            value = value.astype(np.float32) * scale
        elif np.issubdtype(value.dtype, np.floating):
            value = value.astype(np.float32)
        groups[group][rest] = value
    trees = tuple(_unflatten(groups[g]) for g in _GROUPS)
    return trees[0], trees[1], trees[2], meta
