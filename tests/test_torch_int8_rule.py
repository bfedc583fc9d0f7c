"""Phase 16's ``int8``-against-``f32`` rule for the neutron students
(``chip_smoke.int8_rule``: per expert, the 0.999 quantile of the per-shower
relative difference of log1p photon sums within 0.15, and every shower
within 0.25), on the CPU.

The rule it replaces bounded the largest difference over 65536 showers by
0.15, which JAX's own ``fast_neutron_apply`` crosses at seeds 5, 7 and 9
(expert 0's int8 tail). ``tests/fixtures/neutron_int8_rows.npz`` holds
JAX's per-shower log1p sums at seeds 5 and 7 (``experiments/
gate_spread_torch.py int8 --package jax --dump``): the old rule fails on
them and the new one passes; the tile of 128 rows that holds each seed's
largest difference is recomputed here with JAX and equals the file.
Planted faults on the port's serve of the w=0.125 neutron student fail
both rules: one expert's Conv_1 int8 per-output-channel scales times 1.3,
and times 1.5 in one tile only; without them both rules pass.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))

import chip_smoke as cs  # noqa: E402
import gate_spread_torch as gs  # noqa: E402

ROWS = os.path.join(REPO, "tests", "fixtures", "neutron_int8_rows.npz")
TILES = 3  # tiles of gs.INT8_TILE rows in the planted-fault serve


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def old_rule(a, ref):
    return float((np.abs(a - ref) / np.abs(ref)).max()) <= 0.15


@pytest.mark.parametrize("seed", [5, 7])
def test_jax_rows_pass_the_rule_and_fail_the_old_one(seed):
    rows = np.load(ROWS)
    a = rows[f"int8_seed{seed}"].astype(np.float64)
    ref = rows[f"f32_seed{seed}"].astype(np.float64)
    ids = rows[f"ids_seed{seed}"].astype(np.int64)
    assert len(a) == gs.INT8_SHOWERS
    assert not old_rule(a, ref)
    rule = cs.int8_rule(a, ref, ids)
    assert rule["ok"], rule
    assert rule["max"] > 0.15 and max(rule["quantiles"]) <= 0.15


@pytest.mark.parametrize("seed", [5, 7])
def test_jax_rows_are_jax_s(seed):
    """The tile that holds the largest difference, recomputed with JAX's
    ``fast_neutron_apply`` on phase 16's inputs for the seed."""
    from zdcsim.utils.platform import force_cpu

    force_cpu()
    import jax.numpy as jnp

    from zdcsim.models.router import RouterNetwork
    from zdcsim.utils.artifact import load_serving_artifact

    rows = np.load(ROWS)
    a, ref = rows[f"int8_seed{seed}"], rows[f"f32_seed{seed}"]
    router, cond, noise = gs.int8_inputs(seed)
    _, logits = RouterNetwork(n_experts=3).apply({"params": router}, jnp.asarray(cond))
    ids = np.asarray(jnp.argmax(logits, axis=-1))
    np.testing.assert_array_equal(ids, rows[f"ids_seed{seed}"])
    worst = int(np.argmax(np.abs(a.astype(np.float64) - ref) / np.abs(ref)))
    e = int(ids[worst])
    tiles = gs.jax_tiles(np.flatnonzero(ids == e))
    tile = tiles[[worst in t for t in tiles].index(True)][None]
    gp = load_serving_artifact(gs.NEUTRON_STUDENT)[0]
    for name, want in (("int8", a), ("f32", ref)):
        got = np.log1p(gs.jax_tile_sums(gp, e, cond, noise, tile, name == "int8"))[0]
        np.testing.assert_allclose(got, want[tile[0]], rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def serves():
    """The w=0.125 neutron student's expert 1 on ``TILES`` tiles of phase
    16's seed-0 rows, int8 and f32, each tile one call (its own activation
    maxima), as the engine's switch serve decodes them."""
    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim, _decode
    from zdcsim_torch.utils.artifact import load_serving_artifact

    router, cond, noise = gs.int8_inputs(0)
    gp, gstats, _, meta = load_serving_artifact(gs.NEUTRON_STUDENT)
    cfg = load_config(ft._artifact_model_config(meta))
    engines = {p: FastSim(gp, router, batch_size=gs.INT8_TILE, precision=p, device="cpu",
                          cfg=cfg, gen_stats=gstats) for p in ("int8", "f32")}
    n = TILES * gs.INT8_TILE
    z, c = torch.as_tensor(noise[:n]), torch.as_tensor(cond[:n])

    def serve(precision, qweights=None, tile_q=None):
        eng = engines[precision]
        params, q, scales = eng._expert_args(1)
        sums = []
        for t in range(TILES):
            rows = slice(t * gs.INT8_TILE, (t + 1) * gs.INT8_TILE)
            qt = (tile_q or {}).get(t, qweights or q)
            img = _decode(eng._fwd, params, qt, scales, z[rows].to(eng._dtype), c[rows])
            sums.append(np.log1p(img.sum(dim=(1, 2)).double().numpy()))
        return np.concatenate(sums)

    return serve, engines["int8"]._expert_args(1)[1]


def faulty(q, factor):
    """Conv_1's int8 per-output-channel scales times ``factor``."""
    kq, sk = q["Conv_1"]
    return {**q, "Conv_1": (kq, sk * factor)}


def test_planted_faults_fail_both_rules(serves):
    serve, q = serves
    ref = serve("f32")
    ids = np.ones(len(ref), np.int64)
    ok = serve("int8")
    assert old_rule(ok, ref) and cs.int8_rule(ok, ref, ids)["ok"]
    for name, bad in (("expert", serve("int8", qweights=faulty(q, 1.3))),
                      ("one tile", serve("int8", tile_q={1: faulty(q, 1.5)}))):
        assert not old_rule(bad, ref), name
        assert not cs.int8_rule(bad, ref, ids)["ok"], name


def test_rule_reads_each_expert():
    """A fault confined to a small expert moves its quantile, not the
    others' (a quantile over all showers would dilute it)."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(6.0, 12.0, 4000)
    ids = np.where(np.arange(4000) < 3990, 0, 2)  # expert 2 decodes 10 showers
    a = ref * (1 + rng.uniform(-0.05, 0.05, 4000))
    assert cs.int8_rule(a, ref, ids)["ok"]
    a[ids == 2] = ref[ids == 2] * 1.2
    r = cs.int8_rule(a, ref, ids)
    assert not r["ok"] and r["quantiles"][2] > 0.15 and r["quantiles"][0] < 0.06
    assert cs.int8_rule(ref * 1.0, ref, ids)["quantiles"] == [0.0, 0.0, 0.0]
