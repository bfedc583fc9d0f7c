"""The neutron family's dense train step against
``zdcsim.train.step.build_train_step``, on the CPU.

Two systems: ``GeneratorNeutron`` v1 at ``width=0.125`` with
``DiscriminatorNeutron`` and ``AuxRegNeutron``, E=2, batch 8, under
``model.norm=group`` (the preset's) and ``model.norm=batch`` (masked
sub-batch statistics). Both packages step from one JAX state carried across
(``zdcsim_torch.convert``) on JAX's draws: the Gumbel noise and the
generator noises as ``zdcsim/train/step.py:231-247`` draws them, and the
dropout keep masks of the generator (on ``k_g1``: the D phase's fakes and
the G phase's first forward, ``gen_keep_1``; on ``k_g2``: the second,
``gen_keep_2``) and of the aux regressor (``k_aux``), captured from
re-stackings of JAX's classes (:func:`neutron_draws`). Epochs 0 and 40 (the
router frozen); the state's round trip through ``convert`` exact.

Tolerances are ``tests/test_torch_train_step.py``'s: metrics rtol 1e-4,
parameters at ``2 lr``, the EMA's change rtol 1e-4 (beside 1% of ``2 lr``
and float32's rounding of the EMA), frozen experts and router bit for bit; and the BatchNorm running statistics of the generator
and the aux regressor rtol 1e-4. Two differ, each for a reason of
conditioning:

- ``gan_loss`` and ``router_loss`` are held at 1e-4 of the size of the
  terms the GAN term sums (``gan_strength`` times the mean magnitude of the
  routed experts' scores, recorded from the port's step): the term is the
  mean of scores of both signs (here their mean is a fifth to a tenth of
  their mean magnitude), so its own value is no scale for its rounding.
- Adam's moments (the gradients) are held at ``MOMENT_RTOL`` of relative
  norm error per leaf (a leaf under 1% of its component's norm against that
  1%). The generator puts ~10^6 activations through LeakyReLU; one that
  lies within ~1e-6 of the kink (read: 5.3e-7 after ``GroupNorm2d_1``)
  takes slope 1 in one package and 0.1 in the other, and moves the
  gradients of every layer before it in its expert by ~2e-3 (read: 1.7e-3,
  ``norm=group``). Every other leaf agrees within ~1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unittest import mock

import zdcsim_torch.train.step as port_step_module
from test_torch_train_step import LRS, as_jax_state, assert_metrics_match, leaves, paired
from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.models.neutron import AuxRegNeutron as JaxAuxRegNeutron
from zdcsim.models.neutron import GeneratorNeutron as JaxGeneratorNeutron
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config
from zdcsim_torch.convert import train_state_from_jax, train_state_to_jax
from zdcsim_torch.models import build_moe
from zdcsim_torch.train.step import build_train_step

B, E, WIDTH = 8, 2, 0.125
SHAPE = (44, 44)
MOMENT_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def overrides(norm, *extra):
    return [*NEUTRON_OVERRIDES, f"model.norm={norm}", f"model.n_experts={E}",
            f"model.generator.width={WIDTH}", *extra]


def make_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"real": (rng.random((b, *SHAPE, 1)) * 3).astype(np.float32),
            "cond": rng.standard_normal((b, 9)).astype(np.float32),
            "std": rng.random((b, 1)).astype(np.float32),
            "intensity": (rng.random((b, 1)) * 500).astype(np.float32),
            "positions": (rng.random((b, 2)) * 20).astype(np.float32)}


_CAPTURES = {}


def captured_keep(module, variables, arrays, key):
    """The keep masks of ``module``'s ``Dropout`` layers applied in training
    to ``arrays`` on the ``dropout`` key ``key``: the nonzero outputs,
    captured (a keep mask depends on the key and the shape only). One
    compiled capture per module."""
    if id(module) not in _CAPTURES:
        def run(variables, arrays, key):
            _, inter = module.apply(variables, *arrays, True, rngs={"dropout": key},
                                    capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
                                    mutable=["intermediates", "batch_stats"])
            return inter.get("intermediates", {})

        _CAPTURES[id(module)] = (module, jax.jit(run))
    caught = _CAPTURES[id(module)][1](variables, arrays, key)
    return tuple(torch.from_numpy(np.asarray(caught[f"Dropout_{i}"]["__call__"][0]) != 0)
                 for i in range(len(caught)))


def stacked(cls, kwargs, in_axes):
    """``cls`` stacked as ``stack_experts`` stacks it (the ``dropout`` rng
    split per expert), also collecting ``intermediates``."""
    return nn.vmap(cls, in_axes=in_axes, out_axes=0,
                   variable_axes={"params": 0, "batch_stats": 0, "intermediates": 0},
                   split_rngs={"params": True, "dropout": True}, axis_size=E)(**kwargs)


def neutron_draws(norm, state, key):
    """The draws of JAX's dense step on ``key``, as the port takes them. The
    keep masks come from the mask-free stackings of the generator and the
    aux regressor on random inputs: the routing mask of ``norm=batch``
    zeroes rows, not the draws, and without it every output is nonzero."""
    k_gumbel, k_n1, k_n2, k_g1, k_g2, k_aux = jax.random.split(key, 6)
    noise_1 = jax.random.normal(k_n1, (B, 10))
    gen = stacked(JaxGeneratorNeutron, {"norm": norm, "width": WIDTH}, (None, None, None))
    gvars = {"params": state.gen.params, **state.gen.stats}
    gargs = (noise_1, jnp.zeros((B, 9)) + 0.5)
    aux = stacked(JaxAuxRegNeutron, {"norm": norm}, (0, None))
    img = jax.random.uniform(jax.random.PRNGKey(5), (E, B, *SHAPE, 1))
    return {"gumbel": torch.from_numpy(np.array(jax.random.gumbel(k_gumbel, (B, E)))),
            "noise_1": torch.from_numpy(np.array(noise_1)),
            "noise_2": torch.from_numpy(np.array(jax.random.normal(k_n2, (B, 10)))),
            "aux_keep": captured_keep(aux, {"params": state.aux.params, **state.aux.stats},
                                      (img,), k_aux),
            "gen_keep_1": captured_keep(gen, gvars, gargs, k_g1),
            "gen_keep_2": captured_keep(gen, gvars, gargs, k_g2)}


class Run:
    """One norm's JAX state, its steps at epochs 0 and 40, and the port's
    steps from the carried state on the same draws."""

    def __init__(self, norm):
        self.norm = norm
        cfg = jax_load_config(overrides=overrides(norm))
        mods = jax_build_moe(cfg)
        state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
        self.jax_state = jax.tree_util.tree_map(np.array, state)
        self.before = train_state_to_jax(train_state_from_jax(state, "cpu"))
        self.batch = make_batch(11)
        key = jax.random.PRNGKey(17)
        self.draws = neutron_draws(norm, state, key)
        pcfg = load_config(overrides(norm))
        self.pmods = build_moe(pcfg)
        self.port_step = build_train_step(self.pmods, pcfg)
        tbatch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        self.port, self.gan_scale = {}, {}
        for ep in (0, 40):
            scores = []
            hinge = port_step_module.hinge_generator_loss

            def record(s, m):
                scores.append((s * m).detach().abs().sum() / len(m))
                return hinge(s, m)

            with mock.patch.object(port_step_module, "hinge_generator_loss", record):
                self.port[ep] = self.port_step(train_state_from_jax(state, "cpu"), tbatch,
                                               self.draws, ep)
            self.gan_scale[ep] = float(pcfg.model.router.gan_strength) * float(sum(scores))
        step = jax_build_train_step(mods, cfg)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.jax = {}
        for ep in (0, 40):
            fresh = jax.tree_util.tree_map(jnp.copy, state)  # the step donates its state
            new, met = step(fresh, jbatch, key, jnp.asarray(ep, jnp.int32))
            self.jax[ep] = (train_state_to_jax(train_state_from_jax(new, "cpu")),
                            {k: np.asarray(v) for k, v in met.items()})


@pytest.fixture(scope="module", params=["group", "batch"])
def run(request):
    return Run(request.param)


def test_keep_masks_are_jax_dropout(run):
    """The captured masks have the shapes of ``dropout_shapes`` and keep
    about 80%; the two generator keys draw different masks."""
    g, a = run.pmods.generator, run.pmods.aux_reg
    for name, module in (("gen_keep_1", g), ("gen_keep_2", g), ("aux_keep", a)):
        assert [tuple(k.shape) for k in run.draws[name]] == [
            (E, B, *s) for s in module.dropout_shapes], name
        share = torch.cat([k.flatten() for k in run.draws[name]]).float().mean().item()
        assert 0.75 < share < 0.85, (name, share)
    assert not torch.equal(run.draws["gen_keep_1"][2], run.draws["gen_keep_2"][2])


@pytest.mark.parametrize("epoch", [0, 40])
def test_metrics_match_jax(run, epoch):
    assert_metrics_close(run.port[epoch][1], run.jax[epoch][1], run.gan_scale[epoch])


def assert_metrics_close(ours, ref, gan_scale):
    """Every metric at rtol 1e-4 (``assert_metrics_match``), ``gan_loss``
    and ``router_loss`` at 1e-4 of ``gan_scale`` (and of their own size)."""
    summed = ("gan_loss", "router_loss")
    assert_metrics_match({k: v for k, v in ours.items() if k not in summed},
                         {k: v for k, v in ref.items() if k not in summed})
    assert gan_scale > 0
    for k in summed:
        v = np.asarray(ref[k])
        assert abs(ours[k].item() - v) <= 1e-4 * max(gan_scale, abs(v)), (k, ours[k], v)


@pytest.mark.parametrize("comp", ["gen", "disc", "aux", "router"])
def test_adam_state_and_params_match_jax(run, comp):
    ref, ours = run.jax[0][0][comp], train_state_to_jax(run.port[0][0])[comp]
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == 1
    for moment in ("mu", "nu"):
        pairs = paired(ours["opt_state"][moment], ref["opt_state"][moment])
        total = np.sqrt(sum(np.linalg.norm(b) ** 2 for _, _, b in pairs))
        for k, a, b in pairs:
            scale = max(np.linalg.norm(b), 1e-2 * total)
            assert np.linalg.norm(a - b) <= MOMENT_RTOL * scale, (moment, k)
    for k, a, b in paired(ours["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LRS[comp], err_msg=k)


@pytest.mark.parametrize("epoch", [0, 40])
def test_stats_match_jax(run, epoch):
    """The spectral-norm stats per expert by norm at rtol 1e-4; under
    ``norm=batch`` the generator's running statistics (two G-phase forwards,
    ``gst1 -> gst2``) and the aux regressor's (one) at rtol 1e-4, and they
    moved from the initial 0 and 1; under ``group`` there are none."""
    ref, ours = run.jax[epoch][0], train_state_to_jax(run.port[epoch][0])
    for k, a, b in paired(ours["disc"]["stats"], ref["disc"]["stats"]):
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-4 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k
    for comp, n in (("gen", 5), ("aux", 5)):
        pairs = paired(ours[comp]["stats"], ref[comp]["stats"])
        assert len(pairs) == (2 * n if run.norm == "batch" else 0), comp
        for k, a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"{comp} {k}")
            before = dict(leaves(run.before[comp]["stats"]))[k]
            assert not np.array_equal(a, before), (comp, k)


def test_state_round_trips_through_the_port(run):
    """``train_state_to_jax(train_state_from_jax(s))`` gives back JAX's neutron
    state exactly (the discriminator's and aux regressor's trees, the
    generator's and aux regressor's BatchNorm statistics under ``batch``),
    and again from the port's stepped state."""
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(run.jax_state)
    got_leaves, got_tree = jax.tree_util.tree_flatten(as_jax_state(run.before))
    assert got_tree == ref_tree
    for a, b in zip(got_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert bool(run.before["gen"]["stats"]) == bool(run.before["aux"]["stats"]) == (
        run.norm == "batch")
    ours = train_state_to_jax(run.port[0][0])
    for k, a, b in paired(train_state_to_jax(train_state_from_jax(ours, "cpu")), ours):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_ema_and_step_match_jax(run):
    ref, ours = run.jax[0][0], train_state_to_jax(run.port[0][0])
    assert ours["step"] == ref["step"] == 1
    e0s = dict(leaves(run.before["ema_gen_params"]))
    for k, a, b in paired(ours["ema_gen_params"], ref["ema_gen_params"]):
        # 1% of the parameters' 2 lr, and float32's rounding of 0.99 ema + 0.01 params
        np.testing.assert_array_less(np.abs((a - e0s[k]) - (b - e0s[k])),
                                     1e-4 * np.abs(b - e0s[k]) + 0.01 * 2 * LRS["gen"]
                                     + 2.0 ** -22 * np.abs(b), err_msg=k)


def test_router_frozen_from_stop_epoch(run):
    ours, met = run.port[40]
    assert met["router_loss"].item() == 0.0
    for k, a, b in paired(train_state_to_jax(ours)["router"], run.before["router"]):
        assert np.array_equal(a, b), k


def test_expert_of_one_sample_is_frozen(run):
    """Expert 1 routed one sample: its parameters, moments and statistics
    stay bit for bit; expert 0's kernels and statistics move."""
    gumbel = torch.full((B, E), -1e4)
    gumbel[:, 0] = 1e4
    gumbel[B - 1] = torch.tensor([-1e4, 1e4])
    state = train_state_from_jax(run.before, "cpu")
    new, met = run.port_step(state, {k: torch.from_numpy(v) for k, v in run.batch.items()},
                             {**run.draws, "gumbel": gumbel}, 0)
    new = train_state_to_jax(new)
    assert met["n_choosen_experts_mean_epoch"].tolist() == [(B - 1) / B, 1 / B]
    for comp in ("gen", "disc", "aux"):
        for tree in ("params", "stats"):
            for k, a, b in paired(new[comp][tree], run.before[comp][tree]):
                assert np.array_equal(a[1], b[1]), (comp, tree, k)
                if k.endswith(("kernel", "mean")):
                    assert not np.array_equal(a[0], b[0]), (comp, tree, k)
