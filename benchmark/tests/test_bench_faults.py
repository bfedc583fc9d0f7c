"""The check sees a broken timed path: the rest of a run (the harness's look
for a card skipped) with the engine's bulk call broken underneath must come
out not correct, for each fault a serving cell can have
(``harness/faults.py``): answers altered where they are produced (one
tile's, or every one), the rows handed back out of order (across the call,
or within one expert: the dispatch's scatter), an expert id altered (the
router). The engine's tile and form are checked after its build."""

from __future__ import annotations

import pytest
from conftest import run_cpu

from harness.faults import FAULTS, plant
from zdcsim_torch.inference.engine import FastSim


@pytest.mark.parametrize("cell", ["tiny_proton_serve", "tiny_neutron_serve"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, cell, fault):
    spec, _ = tiny
    mend = plant(FAULTS[fault], int(spec.cell(cell)["tile"]))
    try:
        run = run_cpu(spec, cell, seed=11)
    finally:
        mend()
    assert run.result["correct"] is False and run.result["failed"] > 0


@pytest.mark.parametrize("cell", ["tiny_proton_serve", "tiny_neutron_serve"])
def test_sound_run_is_correct(tiny, cell):
    spec, _ = tiny
    run = run_cpu(spec, cell, seed=11)
    assert run.result["correct"] is True
    assert len(run.result["expert_shares"]) == 3


@pytest.mark.parametrize("seed", [5, 5000000004, 2**31 + 9])
def test_router_is_balanced_on_fresh_traffic(tiny, seed):
    """The router's last bias shifted from one draw of the traffic's
    conditions sends about a third of another draw to each expert."""
    import torch

    from conftest import make_run
    from harness.traffic import draw
    from harness.weights import shares

    spec, _ = tiny
    run = make_run(spec, "tiny_neutron_serve", seed=seed)
    _, router, _ = run.spec.module("entries", "serve_bulk").make_weights(run)
    gen = torch.Generator().manual_seed(seed + 1)
    cond = draw({"cond": run.traffic["fields"]["cond"]}, 65536, gen, "cpu", run.settings)["cond"]
    got = shares(run.reference.router(router, cond).argmax(-1), 3)
    assert max(abs(x - 1 / 3) for x in got) < 0.01, got


def test_an_engine_that_ignores_the_tile_stops_the_run(tiny, monkeypatch):
    spec, _ = tiny
    build = FastSim._build_switch
    monkeypatch.setattr(FastSim, "_build_switch",
                        lambda self, tile=128, dyn_dispatch=False: build(self, 8, dyn_dispatch))
    with pytest.raises(SystemExit, match="tile and dyn form"):
        run_cpu(spec, "tiny_proton_serve", seed=11)
