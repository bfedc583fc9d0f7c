"""Tracing (counterpart of ``zdcsim/utils/profiling.py``).

:func:`trace` records one block with ``torch.profiler`` (the CPU and, where
there is one, the CUDA activity) and writes it as a Chrome trace, which
Perfetto and ``chrome://tracing`` open (``train.profile_epoch``).

:func:`span` marks one layer's work in the serve and train paths. It costs
one flag check while no ``torch.profiler`` session records, and returns a
shared no-op context. While one records, a span is a
``torch.profiler.record_function("zdc." + name)`` (on the profiler's
timeline, on the clock of its device records, its ``cpu_parent`` the
enclosing span) and appends a record to a list that :func:`records` reads
and :func:`reset` empties: its name, its enclosing span, its host start and
end on ``time.time_ns()``'s clock (the clock the profiler's CPU events are
stamped on: ``trace_start_ns + time_range * 1000``), and, where CUDA is
initialised and the current stream is not capturing a graph, CUDA events
recorded on the current stream at enter and exit. Spans are opened and
closed on one thread at a time.

A span is a user annotation, as ``record_function`` makes it: the profiler
links no kernel to it, only to the operator that launched the kernel, so a
kernel launched with no operator of its own (a hand-written kernel's ctypes
launch, a CUDA graph's replay) is linked to nothing. An operator-scope
record (torch's ``_RecordFunctionFast``) would link such kernels to the
span, but on the card the profiler then counted each of them twice, and a
profiled call that replays a CUDA graph inside such spans took minutes
longer to read.

Counters are integer attributes of the functions that do the work, always
on, counted on the host from numbers the host already holds: the kernel
wrappers' ``launches`` and their sub-counts (``zdcsim_torch.ops.COUNTERS``),
``tiled_switch_decode.lanes`` (the lanes the switch dispatch decodes, pad
lanes included) and ``FastSim.simulate_switch.showers`` (the real rows the
switch and bulk paths return). :func:`take_counts` and :func:`add_counts`
let a CUDA graph carry the counts of the work it holds: the increments made
during its capture, which runs no work, are taken back, and added again at
each replay.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger(__name__)

SPAN_PREFIX = "zdc."


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


class SpanRecord(NamedTuple):
    """One span as :func:`records` returns it: ``parent`` is the index in
    that list of the enclosing span's record (``None`` at the top); host
    stamps in ns on ``time.time_ns()``'s clock; device stamps in seconds
    from the first device-stamped span's start since :func:`reset`
    (``None`` without CUDA events)."""

    name: str
    parent: Optional[int]
    host_start_ns: int
    host_end_ns: int
    device_start_s: Optional[float]
    device_end_s: Optional[float]


class _Open:
    __slots__ = ("name", "parent", "host_start_ns", "host_end_ns", "events")

    def __init__(self, name: str, parent: Optional["_Open"], events):
        self.name, self.parent, self.events = name, parent, events
        self.host_start_ns = self.host_end_ns = 0


_records: List[_Open] = []
_open: List[_Open] = []  # the open spans, innermost last
_NO_OP = contextlib.nullcontext()


def _device_events() -> Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]:
    """A pair of timing events where one can be recorded on the current
    stream now (never inside a graph capture, where a record is illegal)."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("_fn", "_rec")

    def __init__(self, name: str):
        self._fn = torch.profiler.record_function(SPAN_PREFIX + name)
        self._rec = _Open(name, _open[-1] if _open else None, _device_events())

    def __enter__(self):
        self._fn.__enter__()
        rec = self._rec
        _records.append(rec)
        _open.append(rec)
        rec.host_start_ns = time.time_ns()
        if rec.events is not None:
            rec.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec.events is not None:
            rec.events[1].record()
        rec.host_end_ns = time.time_ns()
        if _open and _open[-1] is rec:
            _open.pop()
        return self._fn.__exit__(*exc)


def span(name: str):
    """The context of one span named ``"zdc." + name`` (see the module
    doc): a shared no-op while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_OP
    return _Span(name)


def reset() -> None:
    """Forget every span recorded so far."""
    _records.clear()
    _open.clear()


def records() -> List[SpanRecord]:
    """The closed spans since :func:`reset`, in the order they opened; one
    device synchronise first where any holds CUDA events."""
    done = [r for r in _records if r.host_end_ns]
    timed = [r for r in done if r.events is not None]
    t0 = None
    if timed:
        torch.cuda.synchronize()
        t0 = timed[0].events[0]
    index = {id(r): i for i, r in enumerate(done)}
    out = []
    for r in done:
        dev = ((None, None) if r.events is None else
               tuple(t0.elapsed_time(ev) * 1e-3 for ev in r.events))
        out.append(SpanRecord(r.name, index.get(id(r.parent)), r.host_start_ns, r.host_end_ns,
                              *dev))
    return out


# ------ counters ------

Counts = Dict[Tuple[object, str], int]


def read_counts(owners: Iterable[object], attrs: Iterable[str]) -> Counts:
    """``{(owner, attr): value}`` of each counter ``attr`` that an owner
    has."""
    attrs = tuple(attrs)
    return {(o, a): int(getattr(o, a)) for o in owners for a in attrs if hasattr(o, a)}


def take_counts(before: Counts) -> Counts:
    """The increments since ``before`` (from :func:`read_counts`), taken
    back from the counters; returns them."""
    delta = {}
    for (owner, attr), v in before.items():
        d = int(getattr(owner, attr)) - v
        if d:
            delta[(owner, attr)] = d
            setattr(owner, attr, v)
    return delta


def add_counts(delta: Counts) -> None:
    """Add ``delta`` (from :func:`take_counts`) to the counters."""
    for (owner, attr), d in delta.items():
        setattr(owner, attr, getattr(owner, attr) + d)
