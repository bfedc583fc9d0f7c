"""The port against the JAX package on the full-width proton teacher
(``artifacts/gate/gate_serving_weights.npz``: 3 experts, Conv_0 512 -> 256).

All three tests share one module-scoped load of the artifact. JAX runs its
Pallas kernels in interpret mode on the CPU; the port runs the plain
versions of its CUDA kernels, which a CPU tensor selects.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.convert import expert, from_jax_params, to_state_dict

TEACHER = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                       "gate_serving_weights.npz")
B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _int8_bound(ref):
    """Bound of tests/test_pallas_decode.py:203 for int8 paths, where a
    rounding flip of one activation cascades through the later convs."""
    return 0.05 * float(np.abs(ref).max()) + 0.05


@pytest.fixture(scope="module")
def teacher():
    gp, _, rp, _ = jax_load(TEACHER)
    return gp, rp


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((B, 10)).astype(np.float32)
    cond = rng.standard_normal((B, 9)).astype(np.float32)
    return noise, cond


def test_float_generator_matches_jax_module(teacher, inputs):
    from zdcsim.models.proton import Generator as JaxGenerator
    from zdcsim_torch.models.proton import Generator

    gp, _ = teacher
    noise, cond = inputs
    p0 = jax.tree_util.tree_map(lambda a: a[0], gp)
    ref = np.asarray(JaxGenerator().apply({"params": p0}, noise, cond, False))
    gen = Generator()
    gen.load_state_dict(to_state_dict(p0))
    with torch.no_grad():
        out = gen(torch.from_numpy(noise), torch.from_numpy(cond)).numpy()
    assert out.shape == ref.shape == (B, 56, 30, 1)
    print("float Generator max |port - jax| =", np.abs(out - ref).max())
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


def test_fast_generator_pallas_ab_matches_jax(teacher, inputs):
    from zdcsim.models.proton_fast import fast_generator_apply as jax_apply
    from zdcsim_torch.models.proton_fast import fast_generator_apply

    gp, _ = teacher
    noise, cond = inputs
    p0 = jax.tree_util.tree_map(lambda a: a[0], gp)
    ref = np.asarray(jax_apply(p0, jnp.asarray(noise), jnp.asarray(cond), int8=True,
                               int8_backend="pallas_ab"))
    gen, _ = from_jax_params(gp, {})
    out = fast_generator_apply(expert(gen, 0), torch.from_numpy(noise), torch.from_numpy(cond),
                               int8=True, int8_backend="pallas_ab").numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    print(f"pallas_ab max |port - jax| = {err} (int8 bound {_int8_bound(ref)})")
    assert err < _int8_bound(ref)


def test_fastsim_int8_pallas_ab_matches_jax_engine(teacher):
    """The slice end to end: router, tiled-switch dispatch, pallas_ab decode
    and expm1, through ``simulate_switch`` at B=4, tile 4."""
    from zdcsim.config import load_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim_torch.inference.engine import FastSim

    gp, rp = teacher
    cond = np.random.default_rng(3).standard_normal((B, 9)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jeng = JaxFastSim(build_moe(load_config(overrides=["model.n_experts=3"])), gp, {}, rp,
                      batch_size=B, precision="int8_pallas_ab")
    jeng._build_switch(tile=4)
    ref, ref_ids = jeng.simulate_switch(cond, key, return_experts=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    # the JAX engine's own noise: sim_switch draws it from the chunk key
    # fold_in(key, 0) (engine.py:412 and :485)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, 10), jnp.bfloat16)
                       .astype(jnp.float32))

    eng = FastSim(gp, rp, batch_size=B, precision="int8_pallas_ab", device="cpu")
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    out, ids = out.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ref_ids)
    assert out.shape == ref.shape == (B, 56, 30)
    assert np.isfinite(out).all() and out.min() >= 0.0
    log_ref, log_out = np.log1p(ref), np.log1p(out)
    err = np.abs(log_out - log_ref).max()
    print(f"FastSim max |log1p port - log1p jax| = {err} (int8 bound {_int8_bound(log_ref)})")
    assert err < _int8_bound(log_ref)
    np.testing.assert_allclose(np.log1p(out.sum(axis=(1, 2))), np.log1p(ref.sum(axis=(1, 2))),
                               rtol=2e-2)
