"""``train_bench_torch.py``, the port's ``train_bench.py``, on the CPU at a tiny
size (width 0.125, batch 8, tile 4, 2 timed steps an arm): its one JSON line
with ``train_bench.py``'s keys, and its refusal to run without a card unless
``--cpu`` is given."""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "scale", "dense", "switch"}
ARM_KEYS = {"ms_per_step", "steps_per_sec", "samples_per_sec", "tflop_per_step",
            "tflops_achieved", "bf16_peak_frac", "peak_mem_gib"}


def run(*args):
    return subprocess.run([sys.executable, "train_bench_torch.py", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))


def test_cpu_run_prints_one_json_line_with_train_bench_keys():
    proc = run("--cpu", "--width", "0.125", "--batch", "8", "--tile", "4", "--steps", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "train_step_throughput" and rec["unit"] == "samples/sec/chip"
    assert rec["scale"] == {"batch": 8, "n_experts": 3, "precision": "bf16", "width": 0.125,
                            "tile": 4, "steps": 2, "card": "cpu"}
    for arm in ("dense", "switch"):
        assert set(rec[arm]) == ARM_KEYS
        assert rec[arm]["samples_per_sec"] > 0 and rec[arm]["tflop_per_step"] > 0
        assert rec[arm]["bf16_peak_frac"] is None and rec[arm]["peak_mem_gib"] is None
    assert rec["value"] == rec["switch"]["samples_per_sec"]
    assert rec["vs_baseline"] == round(rec["dense"]["ms_per_step"] / rec["switch"]["ms_per_step"],
                                       3)
    # the switch arm runs about 1/E of the dense arm's generator work (and the
    # recomputed forwards), never more
    assert rec["switch"]["tflop_per_step"] < rec["dense"]["tflop_per_step"]


def test_no_card_no_run():
    if torch.cuda.is_available():
        return  # on the card the run is the benchmark itself
    proc = run("--steps", "1")
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
