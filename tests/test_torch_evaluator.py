"""The port's evaluator (``zdcsim_torch.train.evaluate``) and
``FastSim.from_state`` against the JAX package's, on the CPU.

The evaluator: JAX's ``build_evaluator`` on its tiny modules (E=3) and the
port's on the JAX state carried across (``convert.train_state_from_jax``),
the port handed JAX's draws, rebuilt from JAX's key derivation
(``zdcsim/train/evaluate.py:159-196``: ``k_route, key = split(key)``, the
routing's Gumbel noise ``fold_in(k_route, c)`` per chunk; per run ``key, kj =
split(key)``, the noise ``fold_in(kj, c)`` per chunk). Cases: epochs 0 and
10 (1 and 3 runs), a test size the chunk does not divide (the padded last
chunk), a chunk whose tile ``gcd(chunk, 64)`` is 1 (every expert, then the
gather), ``eval.sample_routing`` and ``eval.fused_epilogue`` on and off
(kernel E's plain version on the CPU; JAX's Pallas kernel in interpret
mode). The W1 metrics agree within rtol 1e-5, the routing counts and the
router metrics are equal.

``FastSim.from_state``: the proton modules at width 0.125, E=2, ``f32``, on
JAX's noise, within rtol 1e-4 of JAX's ``FastSim.from_state`` on the same
state (the EMA moved off the parameters, so the two choices differ), the
routing identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.config import load_config as jax_load_config
from zdcsim.models.testing import build_tiny_moe as jax_build_tiny_moe
from zdcsim.train.evaluate import build_evaluator as jax_build_evaluator
from zdcsim.train.state import init_state as jax_init_state
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.evaluate import build_evaluator

SHAPE = (8, 6)
E = 3
WS_KEYS = ("ws_mean", "ws_std", "ws_mean_exp", "ws_std_exp", "ws_mean_rel", "ws_real_floor")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def overrides(**over):
    return ["model.n_experts=3", f"dataset.input_image_shape=[{SHAPE[0]}, {SHAPE[1]}]",
            *[f"{k}={v}" for k, v in over.items()]]


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_load_config(overrides=overrides())
    mods = jax_build_tiny_moe(cfg, SHAPE)
    state = jax_init_state(mods, cfg, jax.random.PRNGKey(0))
    port_mods = build_tiny_moe(load_config(overrides()), SHAPE)
    return mods, state, port_mods, train_state_from_jax(state, "cpu")


def make_arrays(n):
    return {"real": jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (n, *SHAPE, 1))),
            "cond": jax.random.normal(jax.random.PRNGKey(2), (n, 9))}


def jax_draws(key, n_true, chunk, epoch, noise_dim):
    """The Gumbel noise ``[n, E]`` and noise ``[n_calc, n, noise_dim]`` JAX's
    evaluator draws from ``key`` (``n`` the padded count)."""
    n = n_true
    if n_true > chunk and n_true % chunk:
        n = n_true + chunk - n_true % chunk
    chunks = max(1, n // chunk) if n >= chunk else 1
    csize = n // chunks
    n_calc = min(epoch // 5 + 1, 5)
    k_route, key = jax.random.split(key)
    gumbel = np.concatenate([np.asarray(jax.random.gumbel(jax.random.fold_in(k_route, c),
                                                          (csize, E), jnp.float32))
                             for c in range(chunks)])
    noise = []
    for _ in range(n_calc):
        key, kj = jax.random.split(key)
        noise.append(np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(kj, c),
                                                                  (csize, noise_dim)))
                                     for c in range(chunks)]))
    return torch.from_numpy(gumbel), torch.from_numpy(np.stack(noise))


CASES = {  # name: (n test showers, chunk, epoch, eval overrides, with expert labels)
    "epoch0": (64, 32, 0, {}, False),
    "epoch10_fused": (64, 32, 10, {"eval.fused_epilogue": "true"}, True),
    "padded_last_chunk_fused": (50, 32, 0, {"eval.fused_epilogue": "true"}, False),
    "tile1_dense_gather": (21, 32, 10, {}, True),
    "sample_routing": (80, 32, 10, {"eval.sample_routing": "true"}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluator_matches_jax(tiny, case):
    mods, state, port_mods, port_state = tiny
    n, chunk, epoch, over, labelled = CASES[case]
    arrays = make_arrays(n)
    labels = np.random.default_rng(3).integers(0, E, n) if labelled else None
    key = jax.random.PRNGKey(7)
    ref = jax_build_evaluator(mods, jax_load_config(overrides=overrides(**over)),
                              chunk_size=chunk)(state, arrays, epoch=epoch, key=key,
                                                expert_labels=labels)
    gumbel, noise = jax_draws(key, n, chunk, epoch, mods.noise_dim)
    ours = build_evaluator(port_mods, load_config(overrides(**over)), chunk_size=chunk)(
        port_state, {k: np.array(v) for k, v in arrays.items()}, epoch,
        expert_labels=labels, noise=noise, gumbel=gumbel)
    assert set(ours) == set(ref)
    for k in WS_KEYS:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(ours["eval_expert_counts"], np.asarray(ref["eval_expert_counts"]))
    assert int(ours["eval_expert_counts"].sum()) == n
    assert ours["epoch"] == ref["epoch"] == epoch
    for k in ("router_accuracy", "router_precision", "router_recall", "router_f1"):
        assert ours.get(k) == ref.get(k), k
    assert ("router_accuracy" in ours) == labelled


def test_evaluator_draws_from_its_generator(tiny):
    """Without given draws, one seed gives one result and the routing is the
    argmax's whatever the seed."""
    _, _, port_mods, port_state = tiny
    arrays = {k: np.array(v) for k, v in make_arrays(64).items()}
    ev = build_evaluator(port_mods, load_config(overrides()), chunk_size=32)
    a = ev(port_state, arrays, 10, torch.Generator().manual_seed(1))
    b = ev(port_state, arrays, 10, torch.Generator().manual_seed(1))
    c = ev(port_state, arrays, 10, torch.Generator().manual_seed(2))
    assert a["ws_mean"] == b["ws_mean"] and a["ws_mean"] != c["ws_mean"]
    np.testing.assert_array_equal(a["eval_expert_counts"], c["eval_expert_counts"])
    with pytest.raises(ValueError, match="noise must be"):
        ev(port_state, arrays, 0, noise=torch.zeros(2, 64, 10))


PROTON = ["model.n_experts=2", "model.generator.width=0.125"]


@pytest.fixture(scope="module")
def proton():
    """JAX's proton modules at width 0.125, E=2, and a state whose EMA is
    off its parameters."""
    from zdcsim.models import build_moe as jax_build_moe
    from zdcsim.train.state import init_state_jit

    cfg = jax_load_config(overrides=PROTON)
    mods = jax_build_moe(cfg)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
    return mods, state.replace(ema_gen_params=jax.tree_util.tree_map(
        lambda p: p * 1.01, state.ema_gen_params))


@pytest.mark.parametrize("use_ema", [True, False])
def test_fastsim_from_state_matches_jax(proton, use_ema):
    """Linear-space showers within rtol 1e-4, with an atol of 1e-5 of the
    largest shower value for the values at ReLU's zero (float32 conv sums
    in another order; the largest such difference seen was 2.3e-6 of a
    largest value near 1)."""
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models import build_moe

    mods, state = proton
    n, key = 16, jax.random.PRNGKey(4)
    cond = np.random.default_rng(6).standard_normal((n, 9)).astype(np.float32)
    ref, ref_ids = JaxFastSim.from_state(mods, state, use_ema=use_ema, batch_size=n).simulate(
        cond, key, return_experts=True)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (n, 10)))
    port_cfg = load_config(PROTON)
    eng = FastSim.from_state(build_moe(port_cfg), train_state_from_jax(state, "cpu"),
                             use_ema=use_ema, batch_size=n, cfg=port_cfg, device="cpu")
    out, ids = eng.simulate(cond, noise=noise, return_experts=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_fastsim_from_state_refuses_the_tiny_modules(tiny):
    from zdcsim_torch.inference.engine import FastSim

    _, _, port_mods, port_state = tiny
    with pytest.raises(ValueError, match="TinyGenerator"):
        FastSim.from_state(port_mods, port_state, device="cpu")
