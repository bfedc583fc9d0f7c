"""``bench_torch.py``, the port's ``bench.py``, on the CPU at tiny sizes.

The full run (batch 32768, 262144 showers through the CUDA graph of the
dyn-dispatch tile loop) needs the card; here the same rungs serve a few
showers so that the output contract, the ladder and its handling of failed rungs
are held.
"""

import json
import os
import subprocess
import sys

import pytest

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "rung"}


def test_cpu_run_prints_one_parseable_json_line():
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--cpu", "--n-showers", "8", "--batch", "4",
         "--tile", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(last) == KEYS
    assert last["metric"] == "fastsim_throughput" and last["unit"] == "showers/sec/chip"
    assert last["value"] > 0 and last["vs_baseline"] == round(last["value"] / 50000.0, 3)
    assert last["rung"] == {"artifact": "artifacts/gate/student_w0.125_serving_weights.npz",
                            "precision": "int8", "batch_size": 4, "tile": 2, "n_showers": 8,
                            "dyn_dispatch": True}
    # three rates and their spread, the routing and the memory on stderr
    line = next(x for x in proc.stderr.splitlines() if "showers/s" in x)
    assert "median" in line and "spread" in line and "routing [" in line
    assert "peak device memory not measured" in line


def test_ladder_is_bench_py_students_then_the_teacher():
    import bench

    rungs = bench_torch.ladder()
    students = [(r["artifact"], r["tile"]) for r in rungs[:5]]
    assert students == list(bench.STUDENT_LADDER)
    assert all(r["precision"] == "int8" and r["batch_size"] == 32768
               and r["n_showers"] == 262144 and r["dyn_dispatch"] for r in rungs[:5])
    teacher = rungs[5:]
    assert {r["artifact"] for r in teacher} == {bench_torch.TEACHER}
    # one rung a precision, in its faster form at tile 256 (the switch loop)
    precisions = ["int8_fused", "bf16", "int8_pallas", "int8_fused_front", "int8_pallas_ab",
                  "int8", "f32"]
    assert [r["precision"] for r in teacher] == precisions
    assert all(r["tile"] == 256 and not r["dyn_dispatch"] for r in teacher)
    # --all: every precision in both dispatch forms, the switch form first
    both = bench_torch.ladder(both_forms=True)[5:]
    assert [(r["precision"], r["dyn_dispatch"]) for r in both] == [
        (p, d) for p in precisions for d in (False, True)]
    swept = bench_torch.ladder(tiles=[64, 128])[5:]
    assert len(swept) == 2 * len(teacher) and {r["tile"] for r in swept} == {64, 128}
    assert len(bench_torch.ladder(tiles=[64, 128], both_forms=True)[5:]) == 4 * len(teacher)


def test_a_failing_rung_names_itself_and_the_next_serves(monkeypatch, capsys):
    served = []

    def run_rung(rung, device, repeats, seed=0):
        served.append(rung["artifact"])
        if len(served) == 1:
            raise RuntimeError("out of memory")
        return {"rates": [3.0, 4.0, 5.0], "median": 4.0, "routing": [1, 2, 3], "peak_bytes": None}

    monkeypatch.setattr(bench_torch, "run_rung", run_rung)
    assert bench_torch.main(["--cpu"]) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["value"] == 4.0 and last["rung"]["artifact"] == served[1]
    assert "student_w0.125_serving_weights.npz int8 batch 32768 tile 128 n 262144 dyn" in err
    assert "RuntimeError: out of memory" in err and "spread (max - min) / median 0.5000" in err


def test_every_rung_failing_still_prints_a_number(monkeypatch, capsys):
    def run_rung(*a, **k):
        raise RuntimeError("no")

    monkeypatch.setattr(bench_torch, "run_rung", run_rung)
    assert bench_torch.main(["--cpu"]) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"metric": "fastsim_throughput", "value": 0.0, "unit": "showers/sec/chip",
                    "vs_baseline": 0.0, "rung": None}


@pytest.mark.parametrize("precision", bench_torch.KERNEL_PRECISIONS)
def test_a_failing_kernel_rung_stops_the_bench(monkeypatch, capsys, precision):
    """A rung that runs hand-written kernels and fails (a kernel that does not
    build or launch) ends the run with no rate: the next, plain rung does not
    serve in its place."""
    served = []
    rungs = bench_torch.ladder(both_forms=True)
    at = next(i for i, r in enumerate(rungs) if r["precision"] == precision)

    def run_rung(rung, device, repeats, seed=0):
        served.append(rung)
        if len(served) <= at + 1 and (len(served) <= 5 or rung["precision"] == precision):
            raise RuntimeError("nvcc failed")
        return {"rates": [3.0, 4.0, 5.0], "median": 4.0, "routing": [1, 2, 3], "peak_bytes": None}

    monkeypatch.setattr(bench_torch, "run_rung", run_rung)
    assert bench_torch.main(["--cpu", "--all"]) == 1
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == {"metric": "fastsim_throughput", "value": 0.0, "unit": "showers/sec/chip",
                    "vs_baseline": 0.0, "rung": None}
    assert served[-1]["precision"] == precision and len(served) == at + 1
    assert "RuntimeError: nvcc failed" in err and "hand-written kernel failed" in err


def test_a_failing_plain_rung_passes_on(monkeypatch, capsys):
    """Rungs that run no hand-written kernel (the students, bf16, int8, f32)
    pass a failure on to the next rung."""
    served = []

    def run_rung(rung, device, repeats, seed=0):
        served.append(rung)
        if rung["precision"] not in bench_torch.KERNEL_PRECISIONS:
            raise RuntimeError("out of memory")
        return {"rates": [3.0, 4.0, 5.0], "median": 4.0, "routing": [1, 2, 3], "peak_bytes": None}

    monkeypatch.setattr(bench_torch, "run_rung", run_rung)
    assert bench_torch.main(["--cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["value"] == 4.0 and last["rung"]["precision"] == "int8_fused"
    assert len(served) == 6


def test_refuses_to_run_without_a_card_unless_asked(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.mark.parametrize("flag,value", [("--n-showers", "6"), ("--batch", "3"), ("--tile", "1")])
def test_overrides_apply_to_every_rung(monkeypatch, capsys, flag, value):
    seen = []

    def run_rung(rung, device, repeats, seed=0):
        seen.append(rung)
        return {"rates": [1.0], "median": 1.0, "routing": [1], "peak_bytes": None}

    monkeypatch.setattr(bench_torch, "run_rung", run_rung)
    assert bench_torch.main(["--cpu", "--all", flag, value]) == 0
    key = {"--n-showers": "n_showers", "--batch": "batch_size", "--tile": "tile"}[flag]
    assert len(seen) == len(bench_torch.ladder(both_forms=True))
    assert all(r[key] == int(value) for r in seen)
