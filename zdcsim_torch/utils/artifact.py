"""Writer and reader of the serving-weight artifacts (``artifacts/gate/*.npz``).

Own copy of the numpy codec of ``zdcsim/utils/artifact.py`` (the port may
not import ``zdcsim``). Float leaves of at least ``INT8_MIN_SIZE`` elements
and two axes are stored int8 with per-output-channel float16 scales under
``<key>::scale``; smaller float leaves are float16; provenance strings sit
under ``__meta__:<name>``. Files are in the Flax layout, so the JAX
package's loader reads what the port writes and the reverse; writing
equals the JAX writer's arrays bit for bit, and loading upcasts every float
leaf to float32, bit-equal to the JAX loader.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np

_GROUPS = ("gen_params", "gen_stats", "router_params")
_META_PREFIX = "__meta__:"
_SCALE_SUFFIX = "::scale"
_SEP = "|"
INT8_MIN_SIZE = 65536  # float leaves at/above this element count (and >= 2-D) go int8


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


def _pack(flat: Dict[str, Any], dtype) -> Dict[str, np.ndarray]:
    """The stored arrays of flat float32 (or other) leaves: per-output-channel
    int8 with the scale taken over every axis but the leading (expert) and
    trailing (channel) axes, ``amax / 127 + 1e-12`` in float32 stored as
    float16, values rounded half to even and clipped at +-127; other float
    leaves in ``dtype``; non-float leaves as they are."""
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            if v.size >= INT8_MIN_SIZE and v.ndim >= 2:
                reduce_axes = tuple(range(0 if v.ndim == 2 else 1, v.ndim - 1))
                amax = np.max(np.abs(v), axis=reduce_axes, keepdims=True)
                scale = (amax / 127.0 + 1e-12).astype(np.float32)
                out[k] = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
                out[f"{k}{_SCALE_SUFFIX}"] = scale.astype(np.float16)
                continue
            v = v.astype(dtype)
        out[k] = v
    return out


def save_serving_artifact(path: str, gen: Dict[str, Any], gen_stats: Optional[Dict[str, Any]],
                          router: Dict[str, Any], meta: Optional[Dict[str, Any]] = None,
                          dtype=np.float16) -> str:
    """Pack the port's serving weights into one compressed ``.npz`` in the
    Flax layout (``zdcsim/utils/artifact.py:63``'s codec).

    ``gen``: the generator tree in the Flax layout as tensors, experts
    stacked in front (what ``convert.from_jax_params`` returns, or
    ``tree_to_torch(from_state_dict(params, stacked=True))`` of a train
    state's); ``gen_stats``: its ``batch_stats`` collection as
    ``convert.stats_from_jax`` returns it (``{}`` or ``None`` for none);
    ``router``: the router's ``state_dict``. They go through
    ``convert.to_jax_params`` and ``convert.stats_to_jax``. ``meta`` values
    are stored as 0-d strings under ``__meta__:`` keys.
    """
    from zdcsim_torch.convert import stats_to_jax, to_jax_params

    gen_np, router_np = to_jax_params(gen, router)
    flat: Dict[str, Any] = {}
    for group, tree in zip(_GROUPS, (gen_np, stats_to_jax(gen_stats or {}), router_np)):
        flat.update(_flatten(tree, f"{group}{_SEP}"))
    out = _pack(flat, dtype)
    for k, v in (meta or {}).items():
        out[f"{_META_PREFIX}{k}"] = np.asarray(str(v))
    np.savez_compressed(path, **out)
    return path


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
