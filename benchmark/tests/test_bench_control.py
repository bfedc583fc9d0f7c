"""The control of each cell's check must come out not correct where the
program comes out correct: for the serving cells the plain reference on a
4-bit grid (the precision below the int8 that they state) put in the
program's place, for the float32 train step the reference with TF32 on.
Here on the CPU at the tiny size (the serving cells; the CPU has no TF32);
on the card (``-m gpu``) at the cells' own size on three seeds, where the
limits were set from (``benchmark/calibrate.py`` reads the dozen seeds and
the controls)."""

from __future__ import annotations

import io

import pytest
import torch
from conftest import make_run, run_cpu

def _control(run, control="int4"):
    entry = run.spec.module("entries", run.cell["entry"])
    return dict((n, (v, lim)) for n, v, lim in
                entry.check(run, *run.extra["check_inputs"], control=control)[1])


@pytest.mark.parametrize("cell", ["tiny_proton_serve", "tiny_neutron_serve"])
def test_control_fails_where_the_program_passes(tiny, cell):
    spec, _ = tiny
    for seed in (21, 22, 23):
        run = run_cpu(spec, cell, seed=seed)
        program = dict((n, v) for n, v, _ in run.checks)
        control = _control(run)
        assert run.correct
        assert any(v > lim and v >= 3 * program[n] for n, (v, lim) in control.items())


@pytest.mark.gpu
@pytest.mark.parametrize("cell, control", [("proton_serve_fused", "int4"),
                                           ("neutron_serve_int8", "int4"),
                                           ("proton_train_dense", "tf32")])
def test_control_fails_at_the_cells_size(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs its kernels at full size")
    from harness.runner import execute
    from harness.spec import Spec

    for seed in (4000000001, 4000000002, 4000000003):
        run = execute(["--workload", cell, "--seed", str(seed), "--seconds", "3"], spec=Spec(),
                      out=io.StringIO(), err=io.StringIO())
        readings = _control(run, control)
        print(cell, seed, {n: v for n, v, _ in run.checks}, {n: v for n, (v, _) in readings.items()})
        assert run.correct
        assert any(v > lim for v, lim in readings.values())
        del run


def test_make_run_is_not_driven(tiny):
    spec, _ = tiny
    run = make_run(spec, "tiny_proton_serve")
    assert run.checks == [] and not run.correct
