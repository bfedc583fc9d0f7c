"""The port against the JAX package on the distilled students, on the CPU.

First the production student (``artifacts/gate/student_w0.125_serving_weights.npz``,
the artifact ``bench.py`` and ``bench_torch.py`` serve first: width 0.125,
channels 64 -> 32 -> 32 -> 32, Dense_1 with 11520 outputs), then the other
four rungs of ``bench_torch.STUDENT_LADDER`` (w=0.1875, 0.25, 0.375, 0.5),
each held the same way before it may serve: the float ``Generator`` per
expert against the JAX module, and ``FastSim("int8")`` against the JAX
engine. Each student is loaded once a module."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.convert import to_state_dict

B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def student():
    gp, gs, rp, meta = jax_load(_artifact("0.125"))
    assert float(meta["width"]) == 0.125
    return gp, gs, rp


def _artifact(width):
    return os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                        f"student_w{width}_serving_weights.npz")


@pytest.mark.parametrize("e", [0, 1, 2])
def test_student_float_generator_matches_jax_module(student, e):
    check_float_generator(student[0], 0.125, e)


def check_float_generator(gp, width, e):
    from zdcsim.models.proton import Generator as JaxGenerator
    from zdcsim_torch.models.proton import Generator

    rng = np.random.default_rng(10 + e)
    noise = rng.standard_normal((B, 10)).astype(np.float32)
    cond = rng.standard_normal((B, 9)).astype(np.float32)
    pe = jax.tree_util.tree_map(lambda a: a[e], gp)
    ref = np.asarray(JaxGenerator(width=width).apply({"params": pe}, noise, cond, False))
    gen = Generator(width=width)
    gen.load_state_dict(to_state_dict(pe))
    with torch.no_grad():
        out = gen(torch.from_numpy(noise), torch.from_numpy(cond)).numpy()
    assert out.shape == ref.shape == (B, 56, 30, 1)
    # tolerance of tests/test_proton_fast.py:33
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


def test_student_fastsim_int8_matches_jax_engine(student):
    """``precision="int8"`` (the plain int32 convs) end to end through
    ``simulate_switch`` at B=4, tile 4, with the JAX engine's own noise."""
    check_fastsim_int8(*student, 0.125)


def check_fastsim_int8(gp, gs, rp, width):
    from zdcsim.config import load_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim_torch.config import load_config as port_config
    from zdcsim_torch.inference.engine import FastSim

    cond = np.random.default_rng(3).standard_normal((B, 9)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    cfg = load_config(overrides=["model.n_experts=3", f"model.generator.width={width}"])
    jeng = JaxFastSim(build_moe(cfg), gp, gs, rp, batch_size=B, precision="int8")
    jeng._build_switch(tile=4)
    ref, ref_ids = jeng.simulate_switch(cond, key, return_experts=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    # sim_switch draws the noise from the chunk key fold_in(key, 0)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, 10), jnp.bfloat16)
                       .astype(jnp.float32))

    eng = FastSim(gp, rp, batch_size=B, precision="int8", device="cpu",
                  cfg=port_config([f"model.generator.width={width}"]))
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    out, ids = out.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ref_ids)
    assert out.shape == ref.shape == (B, 56, 30)
    assert np.isfinite(out).all() and out.min() >= 0.0
    log_ref, log_out = np.log1p(ref), np.log1p(out)
    bound = 0.05 * float(np.abs(log_ref).max()) + 0.05  # tests/test_pallas_decode.py:203
    err = np.abs(log_out - log_ref).max()
    print(f"student w={width} FastSim max |log1p port - log1p jax| = {err} (int8 bound {bound})")
    assert err < bound


@pytest.fixture(scope="module", params=["0.1875", "0.25", "0.375", "0.5"])
def ladder_student(request):
    """One of the other rungs of the student ladder."""
    gp, gs, rp, meta = jax_load(_artifact(request.param))
    assert meta["width"] == request.param
    return gp, gs, rp, float(request.param)


@pytest.mark.parametrize("e", [0, 1, 2])
def test_ladder_student_float_generator_matches_jax_module(ladder_student, e):
    gp, _, _, width = ladder_student
    check_float_generator(gp, width, e)


def test_ladder_student_fastsim_int8_matches_jax_engine(ladder_student):
    check_fastsim_int8(*ladder_student)
