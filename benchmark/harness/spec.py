"""The benchmark's pieces, found by the names that ``BENCHMARK.json`` gives.

Each piece sits in a file of its own under the benchmark's folder, so that a
cell, a configuration, a traffic mix or a per-layer metric is added by adding
files and entries, never by editing one that exists:

- ``workloads/<cell>.json``: the cell's entry, its engine settings and its
  correctness check;
- the configuration's ``file`` (``configs/<config>.json``): its sizes, and the
  name of its plain reference under ``reference/``;
- ``traffic/<traffic>.json``: the parameters that the entry's generator of
  inputs reads;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``entries/<entry>.py``: ``drive(run)``, which sets up, measures and checks.

``dirs`` puts further folders of the same layout before the benchmark's own
(the tests add pieces that way, as a later change adds files).
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List, Optional, Sequence

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, bench_json: Optional[str] = None, dirs: Sequence[str] = ()):
        self.path = bench_json or os.path.join(ROOT, "BENCHMARK.json")
        with open(self.path) as f:
            self.data = json.load(f)
        self.root = os.path.dirname(os.path.abspath(self.path))
        self.dirs = [os.path.abspath(d) for d in dirs] + [BENCH_DIR]

    def _file(self, kind: str, name: str, ext: str) -> str:
        for d in self.dirs:
            path = os.path.join(d, kind, name + ext)
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {self.dirs}")

    def _load_json(self, kind: str, name: str) -> Dict[str, Any]:
        with open(self._file(kind, name, ".json")) as f:
            return json.load(f)

    @staticmethod
    def _entry(items: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
        for item in items:
            if item["name"] == name:
                return item
        raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")

    def cell(self, name: str) -> Dict[str, Any]:
        """The ``workloads`` entry of ``name`` with its file's settings."""
        entry = self._entry(self.data["workloads"], name, "workload")
        return {**self._load_json("workloads", name), **entry}

    def config(self, name: str) -> Dict[str, Any]:
        entry = self._entry(self.data["configs"], name, "config")
        with open(os.path.join(self.root, entry["file"])) as f:
            return {**json.load(f), "name": name}

    def traffic(self, name: str) -> Dict[str, Any]:
        return {**self._load_json("traffic", name), "name": name}

    def metrics(self, cell: str, trace: bool) -> List[Dict[str, Any]]:
        """The metrics a run of ``cell`` reports: the end-to-end ones without
        a trace, the per-layer ones with it; a metric with ``workloads``
        only in the cells it lists."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` as a module of its own (a name may hold dots)."""
        path = self._file(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
