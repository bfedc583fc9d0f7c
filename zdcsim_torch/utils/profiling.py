"""Tracing and step timing (counterpart of ``zdcsim/utils/profiling.py``).

:func:`trace` records one block with ``torch.profiler`` (the CPU and, where
there is one, the CUDA activity) and writes it as a Chrome trace, which
Perfetto and ``chrome://tracing`` open. :class:`StepTimer` reports steady
steps/s with the first steps left out.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``<trace_dir>/trace.json`` (no-op if
    ``None``)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("Profiler trace written to %s", path)


class StepTimer:
    """Steady-state step timing: the first ``warmup_steps`` ticks (the
    first steps choose cuDNN's algorithms and fill the caching allocator)
    are left out."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None
        self._measured = 0

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps + 1:
            self._t0 = time.perf_counter()
        if self._count > self.warmup_steps:
            self._measured = self._count - self.warmup_steps

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._measured < 2:
            return float("nan")
        return (self._measured - 1) / (time.perf_counter() - self._t0)

    def samples_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size
