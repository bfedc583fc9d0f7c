"""The neutron family's switch train step and bf16 step against JAX's, on the
CPU; ``norm=batch`` under the switch step refused as JAX refuses it.

The switch step (``model.norm=group``, ``GeneratorNeutron`` v1 at
``width=0.125``, E=2, batch 8, tile 4) is held against JAX's switch step
from one carried JAX state on JAX's draws: each row's dropout keep masks
rebuilt from JAX's per-(expert, chunk) draws (``zdcsim/train/step.py:561``,
``fold_in(fold_in(k, e), first row of the chunk)``): the generator's of the
D phase on ``k_g1`` over the B rows, of the G phase on ``k_g2`` over the 2B
rows of both noises, the aux regressor's on ``k_aux``
(:func:`neutron_switch_draws`). Tolerances are those of
``tests/test_torch_neutron_train_step.py``. Then the port's switch step
against its dense step on draws that make them the same computation (the
switch G phase's first B rows on the D phase's masks), at the tolerances
of JAX's own test (``tests/test_train_step.py:237-281``).

``tests/test_torch_neutron_train_options.py`` holds the bf16 step and the
refusal of ``norm=batch`` under the switch step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SWITCH_BEYOND_SHARE, switch_draws_as_dense
from test_torch_neutron_train_step import (
    B, E, LRS, MOMENT_RTOL, SHAPE, assert_metrics_close, captured_keep, make_batch, overrides,
    paired,
)
from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax, train_state_to_jax
from zdcsim_torch.inference.switch_dispatch import _chunk_table
from zdcsim_torch.models import build_moe
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise

TILE = 4
SWITCH = ["train.dispatch=switch", f"train.dispatch_tile={TILE}"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def per_row(module, params, key, idx, make_input):
    """Each row's keep masks ``[len(idx), ...]`` under the switch step's
    draws: the chunk table of ``idx`` (``_chunk_table``, the one JAX's
    ``chunk_rows`` computes), and each real row's lanes of JAX's draw for
    its (expert, chunk), captured from ``module`` (JAX's single module) on
    the key ``fold_in(fold_in(key, e), first row of the chunk)``."""
    rows, e_k, used, real = _chunk_table(torch.from_numpy(idx), E, TILE, True)
    keep = None
    for k in np.flatnonzero(used.numpy()):
        ek, r, lanes = int(e_k[k]), rows[k].numpy(), real[k].numpy()
        rng = jax.random.fold_in(jax.random.fold_in(key, ek), int(r[0]))
        masks = captured_keep(module, {"params": jax.tree_util.tree_map(lambda v: v[ek], params)},
                              make_input(), rng)
        if keep is None:
            keep = [np.zeros((len(idx), *m.shape[1:]), bool) for m in masks]
        for kk, m in zip(keep, masks):
            kk[r[lanes]] = m.numpy()[lanes]
    return tuple(torch.from_numpy(k) for k in keep)


def neutron_switch_draws(mods, state, batch, key):
    """The draws of JAX's switch step on ``key`` as the port takes them; the
    routing rebuilt from the state's router and the Gumbel noise."""
    k_gumbel, k_n1, k_n2, k_g1, k_g2, k_aux = jax.random.split(key, 6)
    gumbel = jax.random.gumbel(k_gumbel, (B, E))
    _, logits = mods.router.apply({"params": state.router.params}, jnp.asarray(batch["cond"]))
    idx = np.array(jnp.argmax(logits + gumbel, axis=-1))
    z = lambda: (jnp.ones((TILE, 10)), jnp.ones((TILE, 9)))  # noqa: E731
    img = lambda: (jax.random.uniform(jax.random.PRNGKey(5), (TILE, *SHAPE, 1)),)  # noqa: E731
    return {"gumbel": torch.from_numpy(np.array(gumbel)),
            "noise_1": torch.from_numpy(np.array(jax.random.normal(k_n1, (B, 10)))),
            "noise_2": torch.from_numpy(np.array(jax.random.normal(k_n2, (B, 10)))),
            "aux_keep": per_row(mods.aux_reg_single, state.aux.params, k_aux, idx, img),
            "gen_keep_1": per_row(mods.generator_single, state.gen.params, k_g1, idx, z),
            "gen_keep_2": per_row(mods.generator_single, state.gen.params, k_g2,
                                  np.concatenate([idx, idx]), z)}


class SwitchRun:
    """The JAX state, JAX's switch step, and the port's on the same draws."""

    def __init__(self):
        cfg = jax_load_config(overrides=overrides("group", *SWITCH))
        mods = jax_build_moe(cfg)
        state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
        self.before = train_state_to_jax(train_state_from_jax(state, "cpu"))
        batch = make_batch(12)
        key = jax.random.PRNGKey(19)
        self.draws = neutron_switch_draws(mods, state, batch, key)
        pcfg = load_config(overrides("group", *SWITCH))
        self.pmods = build_moe(pcfg)
        step = build_train_step(self.pmods, pcfg)
        assert step.switch
        self.port = step(train_state_from_jax(state, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()}, self.draws, 0)
        new, met = jax_build_train_step(mods, cfg)(
            jax.tree_util.tree_map(jnp.copy, state), {k: jnp.asarray(v) for k, v in batch.items()},
            key, jnp.asarray(0, jnp.int32))
        self.jax = (train_state_to_jax(train_state_from_jax(new, "cpu")),
                    {k: np.asarray(v) for k, v in met.items()})


@pytest.fixture(scope="module")
def srun():
    return SwitchRun()


def test_switch_draws_are_per_row(srun):
    """One keep mask per row: ``[B, ...]`` for the D phase and the aux
    regressor, ``[2B, ...]`` for the G phase; about 80% kept."""
    g = srun.pmods.generator
    assert [tuple(k.shape) for k in srun.draws["gen_keep_2"]] == [
        (2 * B, *s) for s in g.dropout_shapes]
    for name in ("gen_keep_1", "gen_keep_2", "aux_keep"):
        share = torch.cat([k.flatten() for k in srun.draws[name]]).float().mean().item()
        assert 0.75 < share < 0.85, (name, share)


def test_switch_metrics_match_jax(srun):
    """The router's GAN term is the constant one here: every metric at rtol
    1e-4 (``gan_loss`` and ``router_loss`` beside their size)."""
    ours, ref = srun.port[1], srun.jax[1]
    assert_metrics_close(ours, ref, float(np.abs(ref["gan_loss"])))


@pytest.mark.parametrize("comp", ["gen", "disc", "aux", "router"])
def test_switch_state_matches_jax(srun, comp):
    ref, ours = srun.jax[0][comp], train_state_to_jax(srun.port[0])[comp]
    assert ours["stats"] == {} or comp == "disc"
    for moment in ("mu", "nu"):
        pairs = paired(ours["opt_state"][moment], ref["opt_state"][moment])
        total = np.sqrt(sum(np.linalg.norm(b) ** 2 for _, _, b in pairs))
        for k, a, b in pairs:
            assert np.linalg.norm(a - b) <= MOMENT_RTOL * max(np.linalg.norm(b), 1e-2 * total), (
                moment, k)
    for k, a, b in paired(ours["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LRS[comp], err_msg=k)
    for k, a, b in paired(ours["stats"], ref["stats"]):
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-4 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k


def test_switch_matches_the_dense_step():
    """The port's switch step against its dense step from one state on
    draws that make them one computation: the G phase's first B rows on
    ``gen_keep_1`` (the dense step draws the D phase and the first G-phase
    forward on one key), the dense masks each row's own in its routed
    expert's row (``chip_smoke.switch_draws_as_dense``, phase 20's). Metrics at rtol 2e-4 / atol 1e-5, parameters at rtol 2e-3
    / atol 2e-5 (JAX's test) but for at most ``SWITCH_BEYOND_SHARE`` of
    them, each within ``2 lr`` (``chip_smoke.py`` phase 19's rule: Adam
    moves a parameter whose gradient is zero up to rounding by about ``lr``
    to either side; read here: 14 of 2.8 million elements of ``Dense_1``),
    not counting the leaves whose gradient is zero up to rounding (under
    1e-6 of their component's first-moment norm: at this width each conv
    bias before a GroupNorm of one channel a group, which Adam moves by
    ``lr`` the way its rounding falls)."""
    cfg = load_config(overrides("group"))
    mods = build_moe(cfg)
    state = init_state(mods, cfg, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(13).items()}
    rows, dense_draws = switch_draws_as_dense(
        draw_step_noise(torch.Generator().manual_seed(2), mods, B, "cpu", switch=True), E, B)
    cfg_c = load_config(overrides("group", "model.router.differentiable_gan_term=false"))
    sd, md = build_train_step(mods, cfg_c)(state, batch, dense_draws, 0)
    ss, ms = build_train_step(build_moe(load_config(overrides("group", *SWITCH))),
                              load_config(overrides("group", *SWITCH)))(state, batch, rows, 0)
    for k in ("gen_loss", "disc_loss", "div_loss", "intensity_loss", "aux_reg_loss",
              "n_choosen_experts_mean_epoch"):
        np.testing.assert_allclose(ms[k].numpy(), md[k].numpy(), rtol=2e-4, atol=1e-5, err_msg=k)
    beyond, total = 0, 0
    for name in ("gen", "aux", "router"):
        mu = getattr(sd, name).opt_state.mu
        norm = float(sum(m.double().norm() ** 2 for m in mu.values())) ** 0.5
        for k, v in getattr(sd, name).params.items():
            err = (getattr(ss, name).params[k] - v).abs()
            assert float(err.max()) <= 2 * LRS[name], (name, k)
            if float(mu[k].norm()) > 1e-6 * norm:  # a gradient not zero up to rounding
                beyond += int((err > 2e-5 + 2e-3 * v.abs()).sum())
                total += err.numel()
    assert beyond <= SWITCH_BEYOND_SHARE * total, (beyond, total)
