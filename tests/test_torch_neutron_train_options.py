"""The neutron family's bf16 train step against JAX's, and ``norm=batch``
under the switch step refused as JAX refuses it, on the CPU.

One dense bf16 step under ``model.norm=batch`` (``GeneratorNeutron`` v1 at
``width=0.125``, E=2, batch 8) against JAX's bf16 step on JAX's draws
(``tests/test_torch_neutron_train_step.py``'s :func:`neutron_draws`):
metrics at JAX's bf16 tolerance (rtol 0.1, atol 0.05), the spectral-norm
stats within 1e-3 per expert by norm (``tests/test_torch_train_options.py``'s
bf16 rule), the BatchNorm running statistics within ``BF16_STATS`` per
expert by norm, the master parameters float32.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zdcsim_torch.train.step as port_step_module
from test_torch_neutron_switch_step import SWITCH
from test_torch_neutron_train_step import B, make_batch, neutron_draws, overrides, paired
from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax, train_state_to_jax
from zdcsim_torch.models import build_moe
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise

# bfloat16 moves an activation by up to 2^-8 of itself; a batch mean of
# such activations moves by about that over the mean's cancellation
BF16_STATS = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_bf16_batch_norm_step_matches_jax():
    """``norm=batch`` in bf16 (dense), against JAX's bf16 step on JAX's
    draws."""
    ov = overrides("batch", "train.precision=bf16")
    cfg = jax_load_config(overrides=ov)
    mods = jax_build_moe(cfg)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(6))
    batch = make_batch(14)
    key = jax.random.PRNGKey(23)
    draws = neutron_draws("batch", state, key)
    pcfg = load_config(ov)
    ps, pm = build_train_step(build_moe(pcfg), pcfg)(
        train_state_from_jax(state, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()},
        draws, 0)
    js, jm = jax_build_train_step(mods, cfg)(
        jax.tree_util.tree_map(jnp.copy, state), {k: jnp.asarray(v) for k, v in batch.items()},
        key, jnp.asarray(0, jnp.int32))
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(v), rtol=0.1, atol=0.05, err_msg=k)
    assert all(v.dtype == torch.float32 for v in ps.gen.params.values())
    ref, ours = train_state_to_jax(train_state_from_jax(js, "cpu")), train_state_to_jax(ps)
    for k, a, b in paired(ours["disc"]["stats"], ref["disc"]["stats"]):
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-3 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k
    for comp in ("gen", "aux"):
        pairs = paired(ours[comp]["stats"], ref[comp]["stats"])
        assert len(pairs) == 10
        for k, a, b in pairs:
            err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
            assert np.all(err <= BF16_STATS * np.linalg.norm(b.reshape(len(b), -1), axis=1)), (
                comp, k, err)


def test_switch_refuses_batch_statistics_as_jax():
    """``norm=batch`` with ``train.dispatch=switch``: JAX's switch step and
    the port's raise the same ``ValueError`` on a state with BatchNorm
    statistics."""
    ov = overrides("batch", *SWITCH)
    cfg = jax_load_config(overrides=ov)
    mods = jax_build_moe(cfg)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(0))
    batch = make_batch(15)
    with pytest.raises(ValueError, match="stats-free generator/aux") as ref:
        jax_build_train_step(mods, cfg)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.PRNGKey(1), jnp.asarray(0, jnp.int32))
    pcfg = load_config(ov)
    pmods = build_moe(pcfg)
    step = build_train_step(pmods, pcfg)
    draws = draw_step_noise(torch.Generator().manual_seed(0), pmods, B, "cpu", switch=True)
    with mock.patch.object(port_step_module, "tiled_switch_apply") as dispatch:
        with pytest.raises(ValueError) as ours:
            step(init_state(pmods, pcfg, 0, "cpu"),
                 {k: torch.from_numpy(v) for k, v in batch.items()}, draws, 0)
    assert str(ours.value) == str(ref.value) and not dispatch.called
