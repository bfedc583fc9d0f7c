"""The plain references against the port's float path on the CPU, at width
0.125, on the benchmark's own weights: the router's choice equal, every
shower within float32 rounding (the port folds the neutron BatchNorms into
their layers, decodes Conv_0 as parity phases and sums in another order)."""

from __future__ import annotations

import pytest
import torch
from conftest import make_run


@pytest.mark.parametrize("cell", ["tiny_proton_serve", "tiny_neutron_serve"])
def test_reference_equals_port_float_path(tiny, cell):
    spec, _ = tiny
    run = make_run(spec, cell)
    serve = spec.module("entries", "serve_bulk")
    gen, router, stats = serve.make_weights(run)
    run.cell = {**run.cell, "precision": "f32"}
    engine = serve.build_engine(run, gen, router, stats)
    g = torch.Generator().manual_seed(3)
    cond, noise = torch.randn(16, 9, generator=g), torch.randn(16, 10, generator=g)
    with torch.no_grad():
        imgs, ids = engine.simulate_bulk(cond, noise=noise, return_experts=True)
    ref_ids, _, ref_log = serve.reference_rows(
        run, {"cond": cond, "noise": noise, "decode_ids": ids}, gen, router, stats)
    assert torch.equal(ids, ref_ids)
    assert len(set(ids.tolist())) > 1  # the seeded router spreads the rows
    torch.testing.assert_close(torch.log1p(imgs), ref_log, rtol=1e-4, atol=1e-5)
