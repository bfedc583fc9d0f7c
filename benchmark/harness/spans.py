"""The program's own spans and counters, as the per-layer readers take them
(``zdcsim_torch/utils/profiling.py``): its span records and the serving
counters. Each function returns ``None`` where the program has none of
them, so a reader finds nothing to read there instead of raising."""

from __future__ import annotations

from typing import List, Optional, Tuple


def _profiling():
    try:
        from zdcsim_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def reset() -> None:
    """Forget the program's span records, where it keeps them."""
    p = _profiling()
    if p is not None:
        p.reset()


def records() -> Optional[list]:
    """The program's span records since :func:`reset` (one synchronise), or
    ``None``."""
    p = _profiling()
    return None if p is None else p.records()


def span_share(run, part: str, whole: str) -> Optional[float]:
    """100 x the summed time of the spans named ``part`` over that of the
    spans named ``whole``: device time between each span's CUDA events; on
    a CPU run, where the host is the device, host time. ``None`` where
    either is missing or a span on the card holds no events."""
    recs = records()
    if not recs:
        return None
    parts = [r for r in recs if r.name == part]
    wholes = [r for r in recs if r.name == whole]
    if not parts or not wholes:
        return None
    if all(r.device_start_s is not None for r in parts + wholes):
        secs = [r.device_end_s - r.device_start_s for r in parts + wholes]
    elif run.device.type == "cpu":
        secs = [(r.host_end_ns - r.host_start_ns) * 1e-9 for r in parts + wholes]
    else:
        return None
    total = sum(secs[len(parts):])
    return 100.0 * sum(secs[:len(parts)]) / total if total > 0 else None


def serve_counters() -> Optional[List[Tuple[object, str]]]:
    """``[(owner, attr)]`` of the lanes the switch dispatch decoded and the
    showers the engine returned, or ``None``."""
    try:
        from zdcsim_torch.inference.engine import FastSim
        from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
    except ImportError:
        return None
    found = [(tiled_switch_decode, "lanes"), (FastSim.simulate_switch, "showers")]
    return found if all(hasattr(o, a) for o, a in found) else None
