"""``BENCHMARK.json`` keeps the contract's shape; a cell, a configuration and
a per-layer metric added as files and entries alone are found by name; the
result line has its schema."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import BENCH, ROOT, _dump, _load, run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shape():
    b = _load(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    layer = {m["name"]: m for m in b["per_layer"]}
    names = list(configs) + list(cells) + list(e2e) + list(layer)
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["config"] in configs
        assert os.path.isfile(os.path.join(BENCH, "workloads", w["name"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in list(e2e.values()) + list(layer.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in layer.values():
        assert m["moves"] in e2e and "bound" not in m and m["layer"]
        assert all(w in e2e[m["moves"]].get("workloads", cells) for w in m.get("workloads", []))
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in e2e.values() if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", [w]) for m in layer.values())
    assert len(json.dumps(b)) < 64 * 1024


def test_result_line_schema(tiny):
    spec, _ = tiny
    run = run_cpu(spec, "tiny_proton_serve")
    r = run.result
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"showers_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())


def test_added_files_are_found_by_name(tiny, tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric that a
    later change would add, as new files and new entries only."""
    from harness.spec import Spec

    spec, d = tiny
    extra = str(tmp_path)
    bench = _load(spec.path)
    cfg = _load(os.path.join(d, "configs", "tiny_proton.json"))
    cfg["settings"]["model.n_experts"] = 2
    _dump(cfg, os.path.join(extra, "configs", "tiny_proton_e2.json"))
    traffic = _load(os.path.join(d, "traffic", "tiny_bulk.json"))
    traffic["rows_per_call"] = 8
    _dump(traffic, os.path.join(extra, "traffic", "tiny_bulk8.json"))
    _dump(_load(os.path.join(d, "workloads", "tiny_proton_serve.json")),
          os.path.join(extra, "workloads", "tiny_e2_serve.json"))
    os.makedirs(os.path.join(extra, "metrics"))
    with open(os.path.join(extra, "metrics", "calls.serve.py"), "w") as f:
        f.write("def read(run):\n    return float(run.window['calls'])\n")
    bench["configs"].append({"name": "tiny_proton_e2", "source": "tiny",
                             "file": os.path.join(extra, "configs", "tiny_proton_e2.json"),
                             "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "tiny_e2_serve", "config": "tiny_proton_e2",
                               "traffic": "tiny_bulk8", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "calls.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serve step",
                               "moves": "showers_per_s", "workloads": ["tiny_e2_serve"]})
    for m in bench["end_to_end"]:
        if m["name"] == "showers_per_s":
            m["workloads"].append("tiny_e2_serve")
    _dump(bench, os.path.join(extra, "BENCHMARK.json"))
    spec2 = Spec(os.path.join(extra, "BENCHMARK.json"), dirs=[extra, d])
    r = run_cpu(spec2, "tiny_e2_serve", trace=1).result
    assert r["correct"] and r["metrics"]["calls.serve"]["value"] >= 1
    assert r["attempted"] % 8 == 0
    r0 = run_cpu(spec2, "tiny_e2_serve").result
    assert set(r0["metrics"]) == {"showers_per_s", "setup_s"}


def test_missing_piece_is_an_error(tiny):
    spec, _ = tiny
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.module("metrics", "no_such_metric")
