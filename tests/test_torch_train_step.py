"""One dense train step of the port against ``zdcsim.train.step.build_train_step``,
on the CPU.

Both start from one JAX state carried across (``zdcsim_torch.convert``) and
use the same draws: JAX's ``k_gumbel``, ``k_n1`` and ``k_n2`` split from the
step's key as ``zdcsim/train/step.py:231`` splits them, and the aux
regressor's dropout keep masks recorded from JAX's stacked module on
``k_aux`` (:func:`jax_draws`). Two systems: ``build_tiny_moe`` (E=3) and the
proton modules at ``width=0.125`` (E=2), batch 8.

Tolerances: every metric within rtol 1e-4, the standard deviations of the
photon sums (``std_intensities_experts``) within 1e-4 of the sums they are
taken over (``mean_intensities_experts``): the std of a few nearly equal
sums of ~1000 photons keeps only the digits below the sums' agreement; the
spectral-norm stats and the
EMA's change within rtol 1e-4; Adam's ``mu`` and ``nu`` within 1e-4 of
relative norm error per leaf, where a leaf under 1% of its component's norm
is held at 1e-4 of that 1% (its gradient is a sum that cancels: a conv bias
under a GroupNorm of one channel a group, exactly zero, or the router's last
bias, the per-sample gate derivatives summed over the batch);
``count`` and ``step`` equal. Parameters are
held at ``atol = 2 lr``: after Adam's first step a parameter moves by about
``lr * sign(g)``, so an element whose gradient is near zero may land on
the other side. Frozen experts and a frozen router are held bit for bit.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.models.testing import build_tiny_moe as jax_build_tiny_moe
from zdcsim.models.testing import TinyAuxReg as JaxTinyAuxReg
from zdcsim.models.proton import AuxReg as JaxAuxReg
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax, train_state_to_jax
from zdcsim_torch.models import build_moe
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.step import build_train_step, draw_step_noise

B = 8
SYSTEMS = {"tiny": (["model.n_experts=3"], (8, 6)),
           "proton": (["model.n_experts=2", "model.generator.width=0.125"], (56, 30))}
LRS = {"gen": 1e-4, "disc": 1e-5, "aux": 1e-4, "router": 1e-4}  # default.yaml


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def make_batch(shape, seed):
    rng = np.random.default_rng(seed)
    return {"real": (rng.random((B, *shape, 1)) * 3).astype(np.float32),
            "cond": rng.standard_normal((B, 9)).astype(np.float32),
            "std": rng.random((B, 1)).astype(np.float32),
            "intensity": (rng.random((B, 1)) * 500).astype(np.float32),
            "positions": (rng.random((B, 2)) * 20).astype(np.float32)}


def jax_modules(name, overrides=()):
    ov, shape = SYSTEMS[name]
    cfg = jax_load_config(overrides=[*ov, *overrides])
    return cfg, (jax_build_tiny_moe(cfg, shape) if name == "tiny" else jax_build_moe(cfg))


def port_modules(name, overrides=()):
    ov, shape = SYSTEMS[name]
    cfg = load_config([*ov, *overrides])
    return cfg, (build_tiny_moe(cfg, shape) if name == "tiny" else build_moe(cfg))


def jax_draws(mods, aux_params, key):
    """The draws of JAX's step on ``key`` (``zdcsim/train/step.py:231-247``),
    as the port takes them. The aux regressor's keep masks are the nonzero
    outputs of its ``Dropout`` layers, captured from a re-stacking of its
    class that splits the ``dropout`` rng as ``stack_experts`` does (they
    depend on the rng and the shape only)."""
    k_gumbel, k_n1, k_n2, _, _, k_aux = jax.random.split(key, 6)
    e, nd = mods.n_experts, mods.noise_dim
    aux_cls = JaxTinyAuxReg if mods.names["aux_reg"] == "TinyAuxReg" else JaxAuxReg
    probe = nn.vmap(aux_cls, in_axes=(0, None), out_axes=0,
                    variable_axes={"params": 0, "intermediates": 0},
                    split_rngs={"params": True, "dropout": True}, axis_size=e)()
    img = jax.random.uniform(jax.random.PRNGKey(5), (e, B, *mods.image_shape, 1))
    _, inter = probe.apply({"params": aux_params}, img, True, rngs={"dropout": k_aux},
                           capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
                           mutable=["intermediates"])
    caught = inter.get("intermediates", {})
    keep = tuple(torch.from_numpy(np.asarray(caught[f"Dropout_{i}"]["__call__"][0]) != 0)
                 for i in range(len(caught)))
    return {"gumbel": torch.from_numpy(np.array(jax.random.gumbel(k_gumbel, (B, e)))),
            "noise_1": torch.from_numpy(np.array(jax.random.normal(k_n1, (B, nd)))),
            "noise_2": torch.from_numpy(np.array(jax.random.normal(k_n2, (B, nd)))),
            "aux_keep": keep}


class Run:
    """One system's JAX state, its steps at epochs 0 and 40 (the router
    frozen at 40), and the port's steps from the carried state on the same
    draws."""

    def __init__(self, name):
        self.name = name
        cfg, mods = jax_modules(name)
        state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
        self.jax_state = jax.tree_util.tree_map(np.array, state)
        self.before = train_state_to_jax(train_state_from_jax(state, "cpu"))
        self.batch = make_batch(mods.image_shape, 11)
        key = jax.random.PRNGKey(17)
        self.draws = jax_draws(mods, state.aux.params, key)
        pcfg, self.pmods = port_modules(name)
        self.port_step = build_train_step(self.pmods, pcfg)
        tbatch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        self.port = {ep: self.port_step(train_state_from_jax(state, "cpu"), tbatch, self.draws,
                                        ep) for ep in (0, 40)}
        step = jax_build_train_step(mods, cfg)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.jax = {}
        for ep in (0, 40):
            fresh = jax.tree_util.tree_map(jnp.copy, state)  # the step donates its state
            new, met = step(fresh, jbatch, key, jnp.asarray(ep, jnp.int32))
            self.jax[ep] = (train_state_to_jax(train_state_from_jax(new, "cpu")),
                            {k: np.asarray(v) for k, v in met.items()})


@pytest.fixture(scope="module", params=list(SYSTEMS))
def run(request):
    return Run(request.param)


def leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, sorted by path."""
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    return sorted(kv for k, v in tree.items() for kv in leaves(v, f"{prefix}/{k}"))


def paired(a, b):
    """``(path, leaf of a, leaf of b)``; the two trees have the same paths."""
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    return [(k, x, y) for (k, x), (_, y) in zip(la, lb)]


def rel_norm_err(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("epoch", [0, 40])
def test_metrics_match_jax(run, epoch):
    assert_metrics_match(run.port[epoch][1], run.jax[epoch][1])


def assert_metrics_match(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        o, v = ours[k].numpy(), np.asarray(v)
        scale = np.abs(v)
        if k == "std_intensities_experts":
            scale = np.maximum(scale, np.abs(np.asarray(ref["mean_intensities_experts"])))
        assert o.shape == v.shape and np.all(np.abs(o - v) <= 1e-4 * scale), (k, o, v)


def test_spectral_norm_stats_match_jax(run):
    ref = run.jax[0][0]["disc"]["stats"]
    ours = train_state_to_jax(run.port[0][0])["disc"]["stats"]
    pairs = paired(ours, ref)
    for k, a, b in pairs:  # u per expert by norm (a unit vector), sigma per expert
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-4 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k
    if run.name == "proton":
        assert len(pairs) == 10  # u and sigma of 5 spectral-norm layers
        u = dict(leaves(ref))["/batch_stats/SNConv_0/SpectralNorm_0/Conv_0/kernel/u"]
        np.testing.assert_allclose(np.linalg.norm(u, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("comp", ["gen", "disc", "aux", "router"])
def test_adam_state_and_params_match_jax(run, comp):
    ref, ours = run.jax[0][0][comp], train_state_to_jax(run.port[0][0])[comp]
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == 1
    for moment in ("mu", "nu"):
        pairs = paired(ours["opt_state"][moment], ref["opt_state"][moment])
        total = np.sqrt(sum(np.linalg.norm(b) ** 2 for _, _, b in pairs))
        for k, a, b in pairs:
            scale = max(np.linalg.norm(b), 1e-2 * total)
            assert np.linalg.norm(a - b) <= 1e-4 * scale, (moment, k)
    for k, a, b in paired(ours["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LRS[comp], err_msg=k)


def test_ema_and_step_match_jax(run):
    ref, ours = run.jax[0][0], train_state_to_jax(run.port[0][0])
    assert ours["step"] == ref["step"] == 1
    e0s = dict(leaves(run.before["ema_gen_params"]))
    for k, a, b in paired(ours["ema_gen_params"], ref["ema_gen_params"]):
        np.testing.assert_allclose(a - e0s[k], b - e0s[k], rtol=1e-4, atol=0.01 * 2 * LRS["gen"],
                                   err_msg=k)


def test_router_frozen_from_stop_epoch(run):
    """``stop_router_training_epoch`` (40): the router's parameters and
    optimizer state stay as they were, bit for bit; its loss reads 0."""
    ours, met = run.port[40]
    assert met["router_loss"].item() == 0.0
    after, before = train_state_to_jax(ours)["router"], run.before["router"]
    for k, a, b in paired(after, before):
        assert np.array_equal(a, b), k
    assert not np.array_equal(train_state_to_jax(run.port[0][0])["router"]["params"]
                              ["Dense_0"]["kernel"], before["params"]["Dense_0"]["kernel"])


def as_jax_state(d):
    """The dict form of ``train_state_to_jax`` as JAX's ``MoETrainState``."""
    import optax

    from zdcsim.train.state import Component, MoETrainState

    def comp(c):
        o = c["opt_state"]
        adam = optax.ScaleByAdamState(count=o["count"], mu=o["mu"], nu=o["nu"])
        return Component(params=c["params"], stats=c["stats"],
                         opt_state=(adam, optax.EmptyState()))

    return MoETrainState(**{n: comp(d[n]) for n in ("gen", "disc", "aux", "router")},
                         ema_gen_params=d["ema_gen_params"], step=d["step"])


def test_state_round_trips_through_the_port(run):
    """``train_state_to_jax(train_state_from_jax(s))`` gives back JAX's state
    exactly (same tree, every leaf bit-equal with its dtype), and again from
    the port's own output."""
    back = as_jax_state(run.before)
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(run.jax_state)
    got_leaves, got_tree = jax.tree_util.tree_flatten(back)
    assert got_tree == ref_tree
    for a, b in zip(got_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    ours = train_state_to_jax(run.port[0][0])
    again = train_state_to_jax(train_state_from_jax(ours, "cpu"))
    for k, a, b in paired(again, ours):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def forced_routing(run, idx):
    """The port's step on the run's state and batch with the Gumbel noise
    replaced so that sample ``i`` routes to ``idx[i]``."""
    gumbel = torch.full((B, run.pmods.n_experts), -1e4)
    gumbel[torch.arange(B), torch.as_tensor(idx)] = 1e4
    state = train_state_from_jax(run.before, "cpu")
    new, met = run.port_step(state, {k: torch.from_numpy(v) for k, v in run.batch.items()},
                             {**run.draws, "gumbel": gumbel}, 0)
    return train_state_to_jax(new), met


def test_expert_of_one_sample_is_frozen(run):
    """An expert routed <= 1 sample keeps its parameters, Adam moments and
    stats bit for bit; the others move. The count advances."""
    e = run.pmods.n_experts
    idx = [0] * (B - 1) + [e - 1]  # expert e-1 gets one sample, the middle ones none
    new, met = forced_routing(run, idx)
    assert met["n_choosen_experts_mean_epoch"].tolist()[0] == (B - 1) / B
    for comp in ("gen", "disc", "aux"):
        trees = [new[comp]["params"], new[comp]["opt_state"]["mu"],
                 new[comp]["opt_state"]["nu"], new[comp]["stats"]]
        olds = [run.before[comp]["params"], run.before[comp]["opt_state"]["mu"],
                run.before[comp]["opt_state"]["nu"], run.before[comp]["stats"]]
        for tree, old in zip(trees, olds):
            for k, a, b in paired(tree, old):
                for x in range(1, e):
                    assert np.array_equal(a[x], b[x]), (comp, k, x)
        for k, a, b in paired(new[comp]["params"], olds[0]):
            if k.endswith("kernel"):
                assert not np.array_equal(a[0], b[0]), (comp, k)
        assert new[comp]["opt_state"]["count"] == 1
    assert met["gen_loss_experts"][1:].abs().max().item() == 0.0


def test_step_runs_in_float64(run):
    """The state, batch and draws in float64 (the card-against-CPU check of
    ``chip_smoke.py`` phase 17): the step keeps float64 and its metrics
    agree with the float32 step's."""
    import chip_smoke

    state = train_state_from_jax(run.before, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in run.batch.items()}
    new, met = chip_smoke.step_on(run.port_step, state, batch, run.draws, "cpu", torch.float64)
    assert all(v.dtype == torch.float64 for v in new.gen.params.values())
    assert new.gen.opt_state.count.dtype == torch.int32 and met["gen_loss"].dtype == torch.float64
    assert_metrics_match({k: v.float() for k, v in met.items()}, run.port[0][1])


def test_step_flops_scale_with_the_batch():
    """``chip_smoke.step_flops`` counts the step's matmuls forward and
    backward: twice the batch, twice the operations (the tiny modules have
    no spectral norm, whose power step does not scale)."""
    import chip_smoke

    from zdcsim_torch.train.state import init_state

    cfg, mods = port_modules("tiny")
    state = init_state(mods, cfg, seed=0, device="cpu")
    step = build_train_step(mods, cfg)
    counts = []
    for b in (4, 8):
        batch = {k: torch.from_numpy(v[:b]) for k, v in make_batch((8, 6), 5).items()}
        draws = draw_step_noise(torch.Generator().manual_seed(0), mods, b, "cpu")
        counts.append(chip_smoke.step_flops(lambda: step(state, batch, draws, 0)))
    assert counts[0] > 0 and counts[1] == 2 * counts[0]


def test_unported_options_raise():
    """What still refuses: ``model.norm=batch`` under ``train.dispatch=switch``
    raises JAX's ``ValueError`` (per-sub-batch statistics need the dense
    step); the options of items 6a, 6b and 6c, which raised until they were
    ported, build a step."""
    from zdcsim_torch.config import NEUTRON_OVERRIDES
    from zdcsim_torch.train.state import init_state

    cfg, mods = port_modules("tiny")
    for override in ("train.dispatch=switch", "train.precision=bf16", "train.remat=true",
                     "train.fast_generator=true"):
        step = build_train_step(mods, load_config(["model.n_experts=3", override]))
        assert step.switch == (override == "train.dispatch=switch"), override
        assert step.precision["train.precision"] == ("bf16" if "bf16" in override else "f32")
    neutron = [*NEUTRON_OVERRIDES, "model.n_experts=2", "model.generator.width=0.125"]
    for norm in ("group", "batch"):
        ncfg = load_config([*neutron, f"model.norm={norm}", "train.dispatch=switch",
                            "train.dispatch_tile=4"])
        nmods = build_moe(ncfg)
        step = build_train_step(nmods, ncfg)
        assert step.switch and nmods.names["aux_reg"] == "AuxRegNeutron"
    state = init_state(nmods, ncfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch((44, 44), 11).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(0), nmods, B, "cpu", switch=True)
    with pytest.raises(ValueError, match="requires stats-free generator/aux"):
        step(state, batch, draws, 0)


def test_draw_step_noise_shapes_and_keep_rate():
    _, mods = port_modules("proton")
    d = draw_step_noise(torch.Generator().manual_seed(0), mods, 512, "cpu")
    assert d["gumbel"].shape == (512, 2) and d["noise_1"].shape == (512, 10)
    assert [tuple(k.shape) for k in d["aux_keep"]] == [(2, 512, 128), (2, 512, 64)]
    assert abs(d["aux_keep"][0].float().mean().item() - 0.7) < 0.01
    assert not torch.equal(d["noise_1"], d["noise_2"])


@pytest.mark.parametrize("overrides", [
    ["model.router.differentiable_gan_term=false"], ["model.n_experts=1"],
    ["model.generator.sdi_pairwise_quirk=true", "model.router.ed_strength=0.1",
     "model.router.util_strength=0.1"],
])
def test_tiny_step_options_match_jax(overrides):
    """The constant GAN term, one expert (no router step) and the quirk with
    every router term on, on the tiny modules."""
    cfg, mods = jax_modules("tiny", overrides)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(4))
    port_state = train_state_from_jax(state, "cpu")
    batch = make_batch(mods.image_shape, 12)
    key = jax.random.PRNGKey(21)
    draws = jax_draws(mods, state.aux.params, key)
    _, ref = jax_build_train_step(mods, cfg)(state, {k: jnp.asarray(v) for k, v in
                                                     batch.items()}, key, 3)
    pcfg, pmods = port_modules("tiny", overrides)
    _, ours = build_train_step(pmods, pcfg)(port_state, {k: torch.from_numpy(v) for k, v in
                                                         batch.items()}, draws, 3)
    assert_metrics_match(ours, ref)
