"""The device trace of a window: ``torch.profiler`` over one call, reduced to
what the per-layer readers take.

- ``busy_s``: the union of the device's operation intervals (kernels, copies,
  sets), so overlapping streams count once; ``window_s``: the host clock over
  the call, which ends in a synchronise. Their difference is the time in which
  the device ran nothing.
- ``ops``: every device operation as ``(name, seconds)``; ``launched``: each
  kernel that the profiler links to the host operator that launched it, as
  ``(name, seconds, chain)``, ``chain`` the names of that operator and its
  ancestors (a CUDA graph's replay links none).
- ``idle``: each gap between device operations, named by the benchmark span
  (``bench.*``, see :func:`span`) and the innermost host operation that was
  running at its middle.
"""

from __future__ import annotations

import bisect
import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."


def span(name: str):
    """A host span of the benchmark's own, around a call into one layer."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class Trace:
    def __init__(self, busy_s: float, window_s: float, ops: List[Tuple[str, float]],
                 launched: List[Tuple[str, float, tuple]], idle: Dict[str, float]):
        self.busy_s, self.window_s, self.ops, self.idle = busy_s, window_s, ops, idle
        self.launched = launched

    @property
    def device_s(self) -> float:
        """Summed device time of every operation (overlaps counted twice)."""
        return sum(s for _, s in self.ops)

    def seconds(self, kernel: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name satisfies ``kernel``."""
        return sum(s for name, s in self.ops if kernel(name))

    def launched_by(self, op: Callable[[str], bool]) -> Optional[float]:
        """Device seconds of the kernels whose launching operator, or an
        ancestor of it, satisfies ``op``; ``None`` where the profiler linked
        no kernel to an operator."""
        if not self.launched:
            return None
        return sum(s for _, s, chain in self.launched if any(op(c) for c in chain))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        per = defaultdict(float)
        for name, s in self.ops:
            per[name[:160]] += s
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def record(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (its work queued on the current device) under the
    profiler and reduce its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # a span's copy on the device timeline (a user annotation) is no operation
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPAN_PREFIX)]

    def chain(op) -> tuple:
        names = []
        while op is not None:
            names.append(op.name)
            op = op.cpu_parent
        return tuple(names)

    ops = [(e.name, (e.time_range.end - e.time_range.start) * 1e-6) for e in dev]
    launched = [(k.name, k.duration * 1e-6, chain(e)) for e in cpu for k in e.kernels]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    idle = _name_gaps(merged, cpu)
    return Trace(busy, window_s, ops, launched, idle)


def _name_gaps(merged: List[List[float]], cpu) -> Dict[str, float]:
    """Seconds of each gap between the merged device intervals, summed by
    what the host was doing at the gap's middle: the innermost benchmark
    span and the innermost host event then running."""
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:]) if a1 > b0]
    if not gaps:
        return {}
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu)
    starts = [s for s, _, _ in evs]
    out = defaultdict(float)
    active: list = []  # heap of (-start, end, name)
    i = 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, e, n = evs[i]
            heapq.heappush(active, (-s, e, n))
            i += 1
        inner, bench = None, None
        kept = []
        while active:
            item = heapq.heappop(active)
            if item[1] < mid:
                continue  # ended before this gap, and before every later one
            kept.append(item)
            if inner is None:
                inner = item[2]
            if item[2].startswith(SPAN_PREFIX):
                bench = item[2]
                break
        for item in kept:
            heapq.heappush(active, item)
        name = f"{bench or 'no bench span'} > {inner or 'no host event'}"
        out[name[:160]] += (g1 - g0) * 1e-6
    return dict(out)
