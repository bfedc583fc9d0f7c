"""One run of one cell: find its pieces, let its entry set up, measure and
check, read its metrics, and print the result.

The entry (``entries/<entry>.py``, ``drive(run)``) fills in the fields of
:class:`Run` that the readers read: ``setup_s`` (process start to the first
timed call), ``window`` (``seconds``, ``work``: the units of work completed,
``calls``), ``trace`` (a ``harness.trace.Trace`` of the traced window, with
``trace_work``), ``peak_bytes``, ``checks``: ``(name, value, limit)``,
each compared as ``value <= limit``, and ``report``: what the run did that
the result line states beside them (a serving run's expert shares).

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with a trace ``breakdown``, the
``report``, and last ``checks``: each compared number beside its limit);
the last lines of standard error repeat the report and the checks.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from harness.spec import Spec

# top-level modules that no run may load: the JAX stack and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "zdcsim")


class Run:
    def __init__(self, args, spec: Spec, device, t_start: float):
        self.args, self.spec, self.device, self.t_start = args, spec, device, t_start
        self.seed, self.seconds, self.trace_on = int(args.seed), float(args.seconds), bool(args.trace)
        self.cell = spec.cell(args.workload)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.settings: Dict[str, Any] = self.config["settings"]
        # the cell's reference where it names one (a train step), else its model's
        self.reference = spec.module("reference", self.cell.get("reference",
                                                                self.config["reference"]))
        self.metric_specs = spec.metrics(args.workload, self.trace_on)
        self.readers = {m["name"]: spec.module("metrics", m["name"]) for m in self.metric_specs}
        self.setup_s: Optional[float] = None
        self.window: Dict[str, float] = {}
        self.trace = None
        self.trace_work = 0.0
        self.peak_bytes = 0
        self.checks: List[Tuple[str, float, float]] = []
        self.attempted, self.failed = 0, 0
        self.report: Dict[str, Any] = {}
        self.extra: Dict[str, Any] = {}

    def port_overrides(self) -> List[str]:
        """The configuration's settings as the port's ``load_config``
        overrides."""
        return [f"{k}={json.dumps(v) if isinstance(v, list) else v}"
                for k, v in self.settings.items()]

    def prepare(self) -> None:
        """Set-up that the readers of a traced run need (``prepare(run)``)."""
        for reader in self.readers.values():
            if hasattr(reader, "prepare"):
                reader.prepare(self)

    def mark(self, what: str) -> None:
        """A line on standard error: seconds since the process started."""
        print(f"benchmark: {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)

    def start_window(self) -> float:
        """Mark the end of set-up; returns the window's start."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.checks) and bool(self.checks)

    def metrics(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for m in self.metric_specs:
            value = self.readers[m["name"]].read(self)
            if value is not None and math.isfinite(value):
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def parse(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def device_record(run: Run) -> Dict[str, Any]:
    import torch

    if run.device.type == "cuda":
        kind = torch.cuda.get_device_name(run.device)
        dev = {"platform": "gpu", "kind": kind, "count": int(run.cell["chips"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(run.peak_bytes)
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    return dev


def execute(argv=None, spec: Optional[Spec] = None, device=None, t_start: Optional[float] = None,
            out=sys.stdout, err=sys.stderr) -> Run:
    """One run; returns it, its printed result in ``result``. ``device``
    ``None``: the card, which must hold the cell's chips (a test passes the
    CPU)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = spec or Spec()
    if device is None:
        chips = int(spec.cell(args.workload)["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             "visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(args, spec, torch.device(device), t_start)
    entry = spec.module("entries", run.cell["entry"])
    entry.drive(run)
    gc.collect()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {found}: the JAX stack or the JAX package")
    result = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": run.metrics(), "device": device_record(run)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result.update(run.report)
    for name, v in run.report.items():
        print(f"report {name}: {v!r}", file=err, flush=True)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    run.result = result
    return run


def main(t_start: float) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    execute(t_start=t_start)
    return 0
