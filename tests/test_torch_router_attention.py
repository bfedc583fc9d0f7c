"""The attention router (``zdcsim/models/router.py:50``) in the port: its
forward against Flax's ``apply``, the config and ``build_moe`` choosing it,
one dense train step against JAX's ``build_train_step`` and ``FastSim``'s
routing against JAX's engine.

The step is held at ``test_torch_train_step.py``'s tolerances (its module
docstring says why each is what it is) on the proton modules at width
0.125, E=2, batch 8 (JAX's tiny stand-ins hard-code the MLP router)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (
    B, LRS, assert_metrics_match, jax_draws, leaves, make_batch, paired,
)
from zdcsim.config import load_config as jax_load_config
from zdcsim.inference import FastSim as JaxFastSim
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.models.router import AttentionRouterNetwork as JaxAttentionRouter
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import (
    from_state_dict, to_state_dict, train_state_from_jax, train_state_to_jax,
)
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.models import build_moe
from zdcsim_torch.models.router import AttentionRouterNetwork, build_router, router_version
from zdcsim_torch.train.state import _init_params
from zdcsim_torch.train.step import build_train_step

ATTN = ["model.router.version=router_attention"]
PROTON = ["model.n_experts=2", "model.generator.width=0.125", *ATTN]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def random_tree(e=3, seed=0):
    """Flax's initialised tree with the queries, the norm's scale and bias
    redrawn at unit scale, so that the logits spread."""
    rng = np.random.default_rng(seed)
    cond = jnp.asarray(rng.standard_normal((4, 9)), jnp.float32)
    params = jax.tree_util.tree_map(
        np.array, JaxAttentionRouter(n_experts=e).init(jax.random.PRNGKey(seed), cond)["params"])
    params["expert_queries"] = rng.standard_normal((e, 64)).astype(np.float32)
    params["LayerNorm_0"]["scale"] = (1 + rng.standard_normal(64)).astype(np.float32)
    params["LayerNorm_0"]["bias"] = rng.standard_normal(64).astype(np.float32)
    return params


@pytest.mark.parametrize("tau", [0.7, 1.6])
@pytest.mark.parametrize("gumbel", [False, True])
def test_forward_matches_flax(tau, gumbel):
    e, params = 3, random_tree()
    cond = np.random.default_rng(1).standard_normal((64, 9)).astype(np.float32) * 2
    key = jax.random.PRNGKey(5) if gumbel else None
    g_ref, l_ref = JaxAttentionRouter(n_experts=e).apply({"params": params}, jnp.asarray(cond),
                                                         tau, key)
    noise = (torch.from_numpy(np.array(jax.random.gumbel(key, (64, e), jnp.float32)))
             if gumbel else None)  # gumbel_softmax's draw on the same key
    net = AttentionRouterNetwork(n_experts=e)
    net.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        gates, logits = net(torch.from_numpy(cond), tau, noise=noise)
    np.testing.assert_allclose(logits.numpy(), np.asarray(l_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gates.numpy(), np.asarray(g_ref), rtol=0, atol=1e-5)
    assert np.array_equal(logits.argmax(-1).numpy(), np.asarray(l_ref).argmax(-1))
    assert len(set(logits.argmax(-1).tolist())) == e


def test_state_dict_round_trips_and_eps_is_flax_s():
    params = random_tree(seed=2)
    sd = to_state_dict(params)
    assert sorted(sd) == ["Dense_0.bias", "Dense_0.weight", "Dense_1.bias", "Dense_1.weight",
                          "LayerNorm_0.bias", "LayerNorm_0.weight", "expert_queries"]
    assert torch.equal(sd["expert_queries"], torch.from_numpy(params["expert_queries"]))
    back = from_state_dict(sd)
    for k, a, b in paired(back, params):
        assert np.array_equal(a, b), k
    assert AttentionRouterNetwork().LayerNorm_0.eps == 1e-6


def test_config_and_build_moe_choose_it():
    cfg = load_config(ATTN)
    assert cfg.model.router.version == "router_attention"
    mods = build_moe(cfg)
    assert type(mods.router) is AttentionRouterNetwork
    assert mods.names["router"] == "AttentionRouterNetwork"
    assert router_version(mods.router) == "router_attention"
    assert router_version(build_router(load_config().model)) == "router_v1"
    jmods = jax_build_moe(jax_load_config(overrides=ATTN))
    assert mods.names["router"] == jmods.names["router"]
    with pytest.raises(ValueError, match="router_attention"):
        load_config(["model.router.version=router_v9"])


def test_init_state_draws_flax_s_statistics():
    """``init_state``'s router: ``expert_queries`` N(0, 0.02) as Flax's
    ``normal(stddev=0.02)``, the norm's scale ones and bias zeros; the Dense
    kernels ``lecun_normal``."""
    cfg = load_config(["model.n_experts=64", *ATTN])
    p = _init_params(build_router(cfg.model), None, torch.Generator().manual_seed(0), "cpu")
    q = p["expert_queries"]
    assert q.shape == (64, 64) and abs(float(q.std()) - 0.02) < 0.002
    assert abs(float(q.mean())) < 0.002
    assert torch.equal(p["LayerNorm_0.weight"], torch.ones(64))
    assert torch.equal(p["LayerNorm_0.bias"], torch.zeros(64))
    w = p["Dense_0.weight"]
    assert abs(float(w.std()) * 3 - 1) < 0.15  # variance 1 / fan_in, fan_in 9


class Run:
    """JAX's state and its dense steps at epochs 0 and 40 (the router frozen
    at 40), and the port's steps from the carried state on the same draws."""

    def __init__(self):
        cfg = jax_load_config(overrides=PROTON)
        mods = jax_build_moe(cfg)
        state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
        self.before = train_state_to_jax(train_state_from_jax(state, "cpu"))
        self.batch = make_batch(mods.image_shape, 11)
        key = jax.random.PRNGKey(17)
        draws = jax_draws(mods, state.aux.params, key)
        pcfg = load_config(PROTON)
        step = build_train_step(build_moe(pcfg), pcfg)
        tbatch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        self.port = {ep: step(train_state_from_jax(state, "cpu"), tbatch, draws, ep)
                     for ep in (0, 40)}
        jstep = jax_build_train_step(mods, cfg)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.jax = {}
        for ep in (0, 40):
            fresh = jax.tree_util.tree_map(jnp.copy, state)  # the step donates its state
            new, met = jstep(fresh, jbatch, key, jnp.asarray(ep, jnp.int32))
            self.jax[ep] = (train_state_to_jax(train_state_from_jax(new, "cpu")),
                            {k: np.asarray(v) for k, v in met.items()})


@pytest.fixture(scope="module")
def run():
    return Run()


@pytest.mark.parametrize("epoch", [0, 40])
def test_dense_step_metrics_match_jax(run, epoch):
    assert_metrics_match(run.port[epoch][1], run.jax[epoch][1])


@pytest.mark.parametrize("comp", ["gen", "router"])
def test_dense_step_state_matches_jax(run, comp):
    """Adam's moments within 1e-4 of relative norm per leaf (a leaf under 1%
    of its component's norm at 1e-4 of that 1%), parameters within 2 lr;
    the router's queries and norm moved."""
    ref, ours = run.jax[0][0][comp], train_state_to_jax(run.port[0][0])[comp]
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == 1
    for moment in ("mu", "nu"):
        pairs = paired(ours["opt_state"][moment], ref["opt_state"][moment])
        total = np.sqrt(sum(np.linalg.norm(b) ** 2 for _, _, b in pairs))
        for k, a, b in pairs:
            assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b), 1e-2 * total), (
                moment, k)
    for k, a, b in paired(ours["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LRS[comp], err_msg=k)
    if comp == "router":
        before = dict(leaves(run.before["router"]["params"]))
        after = dict(leaves(ours["params"]))
        for k in ("/expert_queries", "/LayerNorm_0/scale", "/Dense_0/kernel"):
            assert not np.array_equal(after[k], before[k]), k


def test_router_frozen_from_stop_epoch(run):
    ours, met = run.port[40]
    assert met["router_loss"].item() == 0.0
    for k, a, b in paired(train_state_to_jax(ours)["router"], run.before["router"]):
        assert np.array_equal(a, b), k


def test_fastsim_routes_as_jax_engine():
    """``FastSim.from_state`` of a state with the attention router (the
    router's version taken from the modules) routes every condition as JAX's
    engine on the same state; the queries redrawn so that both experts are
    read."""
    cfg = jax_load_config(overrides=PROTON)
    mods = jax_build_moe(cfg)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(4))
    rp = jax.tree_util.tree_map(np.array, state.router.params)
    rp["expert_queries"] = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    state = state.replace(router=state.router.replace(params=rp))
    cond = np.random.default_rng(2).standard_normal((64, 9)).astype(np.float32)
    ref = JaxFastSim.from_state(mods, state, batch_size=64, precision="f32")
    _, ref_ids = ref.simulate_bulk(jnp.asarray(cond), jax.random.PRNGKey(0), return_experts=True)
    pstate = train_state_from_jax(state, "cpu")
    eng = FastSim.from_state(build_moe(load_config(PROTON)), pstate, batch_size=64,
                             precision="f32", device="cpu")
    assert type(eng.router) is AttentionRouterNetwork
    _, ids = eng.simulate_bulk(cond, generator=torch.Generator().manual_seed(0),
                               return_experts=True)
    ref_ids = np.asarray(ref_ids)
    assert np.array_equal(ids.numpy(), ref_ids) and len(set(ref_ids.tolist())) == 2
