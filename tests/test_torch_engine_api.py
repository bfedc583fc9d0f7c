"""The rest of ``FastSim``'s serving API in the port against the JAX engine,
on the CPU: the dense all-expert ``simulate``, ``simulate_grouped`` and
``simulate_stream`` (on the JAX engine's own noise), ``standardize``,
``dyn_dispatch`` against the switch path on every precision's plain path
(mirror of tests/test_switch_dispatch.py:105-181), and the ``throughput_*``
records.

The w=0.125 student serves behind a router drawn from a seed (the student's
own router sends nearly every N(0, 1) condition to expert 1), so that every
expert decodes showers; the fused precisions take the full-width teacher.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim_torch.config import load_config
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.utils.artifact import load_serving_artifact

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate")
B = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seeded_router(seed, widths=(9, 128, 64, 32), n_experts=3):
    """A router in the Flax layout from a seed (LeCun-normal kernels)."""
    rng = np.random.default_rng(seed)
    dims = [*widths, n_experts]
    return {f"Dense_{i}": {"kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                                      / np.sqrt(dims[i])).astype(np.float32),
                           "bias": np.zeros(dims[i + 1], np.float32)}
            for i in range(len(dims) - 1)}


def one_expert_router(e, seed=0):
    """A router that sends every condition to expert ``e``."""
    r = seeded_router(seed)
    r["Dense_3"]["bias"][e] = 1e3
    return r


@pytest.fixture(scope="module")
def student():
    gp, _, _, meta = load_serving_artifact(os.path.join(ART, "student_w0.125_serving_weights.npz"))
    return gp, float(meta["width"])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    return (rng.standard_normal((B, 9)).astype(np.float32),
            rng.standard_normal((B, 10)).astype(np.float32))


def port(gp, width, router, precision, batch_size=B, **kw):
    cfg = load_config([f"model.generator.width={width}"])
    return FastSim(gp, router, batch_size=batch_size, precision=precision, device="cpu",
                   cfg=cfg, **kw)


def jax_engine(gp, width, router, precision, batch_size=B):
    from zdcsim.config import load_config as jax_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe

    cfg = jax_config(overrides=["model.n_experts=3", f"model.generator.width={width}"])
    return JaxFastSim(build_moe(cfg), gp, {}, router, batch_size=batch_size, precision=precision)


def jax_noise(key, n, dtype):
    return np.asarray(jax.random.normal(key, (n, 10), dtype).astype(jnp.float32))


def assert_close(out, ref, precision):
    """f32: log space within the 2e-3 of tests/test_torch_student.py:45;
    int8 (bf16 decode): the log1p bound of tests/test_torch_student.py:75."""
    log_out, log_ref = np.log1p(np.asarray(out)), np.log1p(np.asarray(ref))
    assert log_out.shape == log_ref.shape
    if precision == "f32":
        np.testing.assert_allclose(log_out, log_ref, rtol=2e-3, atol=2e-3)
    else:
        bound = 0.05 * float(np.abs(log_ref).max()) + 0.05
        assert np.abs(log_out - log_ref).max() < bound


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_dense_simulate_matches_jax(student, inputs, precision):
    """Every expert decodes every sample, then the routed gather: against
    JAX's dense ``simulate`` on its own noise (one chunk: ``fold_in(key, 0)``)."""
    gp, width = student
    cond, _ = inputs
    router = seeded_router(40)
    key = jax.random.PRNGKey(4)
    ref, ref_ids = jax_engine(gp, width, router, precision).simulate(cond, key,
                                                                     return_experts=True)
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = jax_noise(jax.random.fold_in(key, 0), B, dtype)
    out, ids = port(gp, width, router, precision).simulate(cond, noise=noise, return_experts=True)
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    assert len(set(ids.tolist())) == 3
    assert_close(out, ref, precision)


def test_dense_batch_size_defaults(student):
    gp, width = student
    router = seeded_router(40)
    eng = port(gp, width, router, "f32", batch_size=None)
    assert FastSim.DENSE_SAFE_BATCH == 2048
    assert (eng.batch_size, eng.dense_batch_size) == (8192, 2048)
    assert port(gp, width, router, "f32", batch_size=16).dense_batch_size == 16


def test_dense_simulate_chunks_and_pads(student):
    """13 samples in chunks of 8: the padded last chunk decodes as a whole
    chunk of those rows does (f32, where the per-tensor int8 scale plays no
    part)."""
    gp, width = student
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((13, 9)).astype(np.float32)
    noise = rng.standard_normal((13, 10)).astype(np.float32)
    eng = port(gp, width, seeded_router(40), "f32")
    out = eng.simulate(cond, noise=noise)
    tail = eng.simulate(cond[8:], noise=noise[8:])
    assert out.shape == (13, 56, 30)
    torch.testing.assert_close(out[8:], tail, rtol=0, atol=0)


def grouped_noise(key, idx, dtype, chunk=None):
    """Per-sample noise as JAX's grouped (``fold_in(key, e)``) or stream
    (``fold_in(key, e * 100003 + start)``, chunks of ``chunk``) dispatch
    draws it, bucket by bucket."""
    noise = np.zeros((len(idx), 10), np.float32)
    for e in range(3):
        sel = np.flatnonzero(idx == e)
        starts = [0] if chunk is None else range(0, sel.size, chunk)
        for start in starts:
            part = sel[start:] if chunk is None else sel[start:start + chunk]
            size = part.size if part.size == chunk else FastSim._bucket_size(part.size)
            k = jax.random.fold_in(key, e if chunk is None else e * 100003 + start)
            noise[part] = jax_noise(k, size, dtype)[:part.size]
    return noise


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["grouped", "stream"])
def test_grouped_and_stream_match_jax(student, inputs, precision, mode):
    """Host-side buckets through the float Generator module in the compute
    dtype (JAX's ``decode_one``), on JAX's per-bucket noise; the stream path
    at batch 4, so one expert's samples span two chunks."""
    gp, width = student
    cond, _ = inputs
    router = seeded_router(40)
    key = jax.random.PRNGKey(6)
    batch = 4 if mode == "stream" else B
    jeng = jax_engine(gp, width, router, precision, batch)
    ref = np.asarray(getattr(jeng, f"simulate_{mode}")(cond, key))
    eng = port(gp, width, router, precision, batch_size=batch)
    idx = eng._route(torch.from_numpy(cond)).numpy()
    assert np.array_equal(idx, np.asarray(jeng._route(jeng._weights, cond)))
    if mode == "stream":
        assert np.bincount(idx, minlength=3).max() > batch
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = grouped_noise(key, idx, dtype, batch if mode == "stream" else None)
    out, ids = getattr(eng, f"simulate_{mode}")(cond, noise=noise, return_experts=True)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert np.array_equal(ids.numpy(), idx)
    assert_close(out, ref, precision)


def test_stream_without_readback_returns_device_chunks(student, inputs):
    gp, width = student
    cond, noise = inputs
    eng = port(gp, width, seeded_router(40), "f32", batch_size=4)
    pending = eng.simulate_stream(cond, noise=noise, readback=False)
    full = eng.simulate_stream(cond, noise=noise)
    assert sorted(np.concatenate([p for p, _ in pending]).tolist()) == list(range(B))
    for part, imgs in pending:
        assert torch.equal(imgs[:part.size], full[torch.from_numpy(part)])


def test_standardize_matches_jax():
    from zdcsim.data.scalers import StandardScaler as JaxScaler
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim_torch.data.scalers import StandardScaler

    raw = np.random.default_rng(2).standard_normal((64, 9)) * 7 + 3
    x = raw[:5]
    ref = JaxFastSim.standardize(type("E", (), {"scaler_cond": JaxScaler().fit(raw)})(), x)
    out = FastSim.standardize(type("E", (), {"scaler_cond": StandardScaler().fit(raw)})(), x)
    assert out.dtype == np.float32 and np.array_equal(out, ref)
    bare = JaxFastSim.standardize(type("E", (), {"scaler_cond": None})(), x)
    assert np.array_equal(FastSim.standardize(type("E", (), {"scaler_cond": None})(), x), bare)


def test_engine_standardize_uses_its_scaler(student):
    from zdcsim_torch.data.scalers import StandardScaler

    gp, width = student
    raw = np.random.default_rng(3).standard_normal((32, 9)) * 2 + 1
    sc = StandardScaler().fit(raw)
    eng = port(gp, width, seeded_router(40), "f32", scaler_cond=sc)
    assert np.array_equal(eng.standardize(raw), sc.transform(raw))


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int8_pallas_ab", "int8_pallas"])
@pytest.mark.parametrize("routing", ["spread", "one expert"])
def test_dyn_dispatch_equals_switch(student, precision, routing):
    """The branchless decoder on weights gathered by the tile's expert equals
    the per-expert path bit for bit, with every expert read and with one
    expert taking all (the others empty); ``simulate_bulk`` is the same
    eager loop on the CPU."""
    gp, width = student
    router = seeded_router(40) if routing == "spread" else one_expert_router(2)
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((2 * B, 9)).astype(np.float32)
    noise = rng.standard_normal((2 * B, 10)).astype(np.float32)
    eng = port(gp, width, router, precision)
    eng._build_switch(tile=4)
    a, ia = eng.simulate_switch(cond, noise=noise, return_experts=True)
    counts = np.bincount(ia.numpy(), minlength=3)
    assert (counts.min() > 0) if routing == "spread" else (counts[2] == 2 * B)
    eng._build_switch(tile=4, dyn_dispatch=True)
    b, ib = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert torch.equal(a, b) and torch.equal(ia, ib)
    assert torch.equal(eng.simulate_bulk(cond, noise=noise), a)


@pytest.fixture(scope="module")
def teacher():
    return load_serving_artifact(os.path.join(ART, "gate_serving_weights.npz"))[0]


@pytest.mark.parametrize("precision", ["int8_fused_front", "int8_fused"])
def test_dyn_dispatch_equals_switch_on_the_fused_precisions(teacher, precision):
    """The fused precisions (full width): the stacked packed weights of G and
    H, gathered per tile, decode as the per-expert path does."""
    router = seeded_router(40)
    rng = np.random.default_rng(9)
    cond = rng.standard_normal((4, 9)).astype(np.float32)
    noise = rng.standard_normal((4, 10)).astype(np.float32)
    eng = FastSim(teacher, router, batch_size=4, precision=precision, device="cpu")
    eng._build_switch(tile=2)
    a, ia = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert len(set(ia.tolist())) >= 2
    eng._build_switch(tile=2, dyn_dispatch=True)
    b, ib = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert torch.equal(a, b) and torch.equal(ia, ib)


def test_build_switch_drops_the_captured_graphs(student):
    gp, width = student
    eng = port(gp, width, seeded_router(40), "int8")
    eng._build_switch(tile=4, dyn_dispatch=True)
    eng._graphs[(B, 4)] = "captured"
    eng._build_switch(tile=2, dyn_dispatch=True)
    assert eng._graphs == {} and eng._tile == 2 and eng._stacked is not None
    eng._build_switch(tile=2)
    assert eng._stacked is None and eng._decode_dyn is None


def test_throughput_records(student):
    gp, width = student
    eng = port(gp, width, seeded_router(40), "int8", batch_size=4)
    gen = torch.Generator().manual_seed(0)
    for stats, n in ((eng.throughput(n_batches=2, warmup=1, generator=gen), 8),
                     (eng.throughput_switch(n_batches=2, warmup=1, generator=gen), 8),
                     (eng.throughput_bulk(n_showers=6, generator=gen), 6),
                     (eng.throughput_stream(n_showers=6, warmup=False, generator=gen), 6),
                     (eng.throughput_grouped(n_batches=1, warmup=0, generator=gen), 4)):
        assert set(stats) == {"showers_per_sec", "batch_size", "seconds", "n_showers"}
        assert stats["n_showers"] == n and stats["batch_size"] == 4.0
        assert stats["showers_per_sec"] > 0 and stats["seconds"] > 0


@pytest.mark.parametrize("precision", ["int8", "int8_pallas", "bf16"])
def test_engine_leaves_no_reference_cycle(student, precision):
    """An engine is freed as soon as it is dropped, with the collector off:
    its decoders hold no reference back to it. A cycle would leave its CUDA
    graphs to a collection that may fall inside another engine's capture."""
    import gc
    import weakref

    gp, width = student
    enabled = gc.isenabled()
    gc.disable()
    try:
        eng = port(gp, width, seeded_router(40), precision, batch_size=4)
        eng._build_switch(tile=2, dyn_dispatch=True)
        eng.simulate_bulk(np.zeros((4, 9), np.float32))
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
