"""The train step's options against ``zdcsim``'s, on the CPU:
``train.precision=bf16``, ``train.remat``, ``train.fast_generator`` (the
fused convs' custom backward included), and the step's determinism.

Twins of ``tests/test_train_step.py:68 test_step_deterministic`` (held here
with ``torch.equal`` on every metric and state leaf, stricter than JAX's
rtol 1e-6), ``:199 test_bf16_training_step_runs``, ``:219
test_remat_step_matches_plain`` and ``tests/test_proton_fast.py:70
test_fused_conv_gradients_match_naive``, ``:182 test_fast_generator_trains``,
at those tests' tolerances. The fast generator's step is held at width
0.125 (JAX's test runs full width; the CPU suite cannot). Against JAX's own
step on JAX's draws (``test_torch_train_step.jax_draws``; proton width
0.125, E=2, batch 8): the bf16 step's metrics within limits set between
that gap and the float32 step's gap to JAX's bf16 step where the two
separate (``BF16_SEPARATING``), the rest at JAX's bf16 tolerance (rtol
0.1, atol 0.05) or tighter, its spectral-norm stats within 1e-3 per expert by norm (the
power step reads bfloat16-rounded kernels, and the two steps' updated
kernels, 2 lr apart where a gradient is near zero, can round to
neighbouring bfloat16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import B, jax_draws, jax_modules, make_batch, paired, port_modules
from zdcsim.models.proton_fast import fused_row_resize_conv4 as jax_fused_rr
from zdcsim.models.proton_fast import fused_upsample2_conv4 as jax_fused_up
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import (
    flax_view, from_state_dict, train_state_from_jax, train_state_to_jax,
)
from zdcsim_torch.models import build_moe
from zdcsim_torch.models.layers import resize_nearest
from zdcsim_torch.models.proton_fast import _conv, fused_row_resize_conv4, fused_upsample2_conv4
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise

SHAPE = (8, 6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny_step(*over, b=16, seed=0):
    """``(step, state, batch, draws)`` of the tiny modules (E=3), the state and
    draws from ``seed``, the batch from ``seed + 1``."""
    cfg = load_config(["model.n_experts=3", f"train.batch_size={b}", *over])
    mods = build_tiny_moe(cfg, SHAPE)
    step = build_train_step(mods, cfg)
    g = torch.Generator().manual_seed(seed + 1)
    batch = {"real": torch.randn((b, *SHAPE, 1), generator=g).abs(),
             "cond": torch.randn((b, 9), generator=g),
             "std": torch.rand((b, 1), generator=g),
             "intensity": torch.rand((b, 1), generator=g) * 100,
             "positions": torch.rand((b, 2), generator=g) * 6}
    draws = draw_step_noise(torch.Generator().manual_seed(seed), mods, b, "cpu", step.switch)
    return step, init_state(mods, cfg, seed, "cpu"), batch, draws


def all_leaves(state):
    """Every tensor of a train state by path."""
    out = {"step": state.step, "ema": state.ema_gen_params}
    for name in ("gen", "disc", "aux", "router"):
        c = getattr(state, name)
        out.update({f"{name}/params": c.params, f"{name}/stats": c.stats,
                    f"{name}/mu": c.opt_state.mu, f"{name}/nu": c.opt_state.nu,
                    f"{name}/count": c.opt_state.count})
    flat = {}
    for k, v in out.items():
        flat.update({f"{k}/{kk}": vv for kk, vv in v.items()} if isinstance(v, dict) else {k: v})
    return flat


# ------ determinism (F1) ------

@pytest.mark.parametrize("options", [
    [], ["train.dispatch=switch", "train.dispatch_tile=4"], ["train.precision=bf16"],
    ["train.fast_generator=true", "train.remat=true"],
], ids=["dense", "switch", "bf16", "fast-remat"])
def test_step_deterministic(options):
    """Two steps from one state on one set of draws: every metric and every
    state leaf ``torch.equal`` (proton width 0.125, E=2, batch 8)."""
    cfg, mods = port_modules("proton", options)
    step = build_train_step(mods, cfg)
    state = init_state(mods, cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(mods.image_shape, 2).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(1), mods, B, "cpu", step.switch)
    (s1, m1), (s2, m2) = (step(state, batch, draws, 0) for _ in range(2))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    a, b = all_leaves(s1), all_leaves(s2)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_step_restores_the_backend_settings():
    """The step's precision and determinism settings hold inside it only."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled())
    step, state, batch, draws = tiny_step()
    step(state, batch, draws, 0)
    assert (cudnn.deterministic, cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == before
    assert step.precision["cudnn.deterministic"] is True
    assert step.precision["cudnn.benchmark"] is False


# ------ bf16 ------

def test_bf16_training_step_runs():
    """Finite, the master parameters float32, ``disc_loss`` within rtol 0.1 /
    atol 0.05 of the float32 step's on the same batch."""
    step, state, batch, draws = tiny_step("train.precision=bf16")
    new, m = step(state, batch, draws, 0)
    assert np.isfinite(m["gen_loss"].item())
    assert all(v.dtype == torch.float32 for v in new.gen.params.values())
    step32, state32, _, _ = tiny_step()
    _, m32 = step32(state32, batch, draws, 0)
    np.testing.assert_allclose(m["disc_loss"].item(), m32["disc_loss"].item(), rtol=0.1,
                               atol=0.05)


def jax_step_pair(options):
    """JAX's step and the port's on the proton system from one state on
    JAX's draws: ``(port (state, metrics), JAX (state dict, metrics))``."""
    cfg, mods = jax_modules("proton", options)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
    batch = make_batch(mods.image_shape, 11)
    key = jax.random.PRNGKey(17)
    draws = jax_draws(mods, state.aux.params, key)
    pcfg, pmods = port_modules("proton", options)
    port = build_train_step(pmods, pcfg)(train_state_from_jax(state, "cpu"),
                                         {k: torch.from_numpy(v) for k, v in batch.items()},
                                         draws, 0)
    new, met = jax_build_train_step(mods, cfg)(state, {k: jnp.asarray(v) for k, v in
                                                       batch.items()}, key, 0)
    return port, (train_state_to_jax(train_state_from_jax(new, "cpu")),
                  {k: np.asarray(v) for k, v in met.items()})


# Relative errors of the port's bf16 step's metrics against JAX's bf16 step
# (:func:`test_bf16_step_matches_jax`), each between the two readings of that
# case: the port's bf16 step against JAX's, and the port's float32 step
# against JAX's bf16 step. Readings (bf16 | f32): gen_loss 1.88e-3 | 5.12e-3,
# intensity_loss 8.39e-5 | 2.47e-3, mean_intensities_experts 1.59e-4 |
# 3.39e-3, std_intensities_experts 1.39e-2 | 2.24e-1, differentiation_loss
# 2.53e-4 | 9.38e-3. These read the generator's bf16 forward.
BF16_SEPARATING = {"gen_loss": 3e-3, "intensity_loss": 5e-4, "mean_intensities_experts": 7e-4,
                   "std_intensities_experts": 5e-2, "differentiation_loss": 1.5e-3}
# Held at about three times the bf16 reading; no limit separates these two
# from the float32 step (bf16 | f32): disc_loss 8.92e-4 | 2.58e-4 (the
# discriminator's bf16 forward is the float32 forward on bfloat16-rounded
# inputs), aux_reg_loss 2.06e-4 | 3.03e-4, and 1.93e-4 with the aux
# regressor left in float32. test_bf16_step_casts_at_each_use holds the casts.
BF16_HELD = {"disc_loss": 3e-3, "aux_reg_loss": 1e-3}


def test_bf16_step_matches_jax():
    """The metrics in ``BF16_SEPARATING`` and ``BF16_HELD`` within their
    relative limits of JAX's bf16 step (see there for the readings), the
    rest at JAX's bf16 tolerance (rtol 0.1, atol 0.05); the discriminator's
    parameters float32 and its spectral-norm stats within 1e-3 per expert
    by norm."""
    (ps, pm), (js, jm) = jax_step_pair(["train.precision=bf16"])
    assert set(pm) == set(jm)
    for k, v in jm.items():
        rtol = {**BF16_SEPARATING, **BF16_HELD}.get(k)
        if rtol is None:
            np.testing.assert_allclose(pm[k].numpy(), v, rtol=0.1, atol=0.05, err_msg=k)
        else:
            np.testing.assert_allclose(pm[k].numpy(), v, rtol=rtol, atol=0, err_msg=k)
    assert all(v.dtype == torch.float32 for v in ps.disc.params.values())
    pairs = paired(train_state_to_jax(ps)["disc"]["stats"], js["disc"]["stats"])
    assert len(pairs) == 10  # u and sigma of 5 spectral-norm layers
    for k, a, b in pairs:
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-3 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k
        if k.endswith("/u"):
            np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-5)


def test_bf16_step_casts_at_each_use():
    """In the bf16 step the generator and the aux regressor run on bfloat16
    parameters and inputs, and the discriminator on float32 parameters and
    inputs that are bfloat16-rounded (JAX's promotion through its float32
    ``u``); in the float32 step all three run in float32."""
    for precision, low in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg, mods = port_modules("proton", [f"train.precision={precision}"])
        seen = {}

        def record(name):
            def hook(module, args):
                seen.setdefault(name, []).append(
                    (args[0], [p.dtype for p in module.parameters()]))
            return hook

        for name in ("generator", "discriminator", "aux_reg"):
            getattr(mods, name).register_forward_pre_hook(record(name))
        batch = {k: torch.from_numpy(v) for k, v in make_batch(mods.image_shape, 2).items()}
        draws = draw_step_noise(torch.Generator().manual_seed(1), mods, B, "cpu")
        build_train_step(mods, cfg)(init_state(mods, cfg, 0, "cpu"), batch, draws, 0)
        assert seen.keys() == {"generator", "discriminator", "aux_reg"}
        for name, calls in seen.items():
            want = torch.float32 if name == "discriminator" else low
            for x, dtypes in calls:
                assert x.dtype == want and set(dtypes) == {want}, (precision, name)
                if name == "discriminator" and precision == "bf16":
                    assert torch.equal(x, x.to(torch.bfloat16).to(x.dtype)), name


# ------ remat ------

def test_remat_step_matches_plain():
    """``gen_loss`` and ``disc_loss`` within rtol 1e-5 of the plain step's."""
    step_r, state, batch, draws = tiny_step("train.remat=true")
    step_p = tiny_step()[0]
    (_, m_r), (_, m_p) = step_r(state, batch, draws, 0), step_p(state, batch, draws, 0)
    for k in ("gen_loss", "disc_loss"):
        np.testing.assert_allclose(m_r[k].item(), m_p[k].item(), rtol=1e-5, err_msg=k)


def test_remat_proton_step_matches_plain():
    """The proton modules (spectral norm, dropout): every metric within
    rtol 1e-5 of the plain step's, the spectral-norm stats of the first
    forward kept."""
    cfg_r, mods = port_modules("proton", ["train.remat=true"])
    cfg_p, _ = port_modules("proton")
    state = init_state(mods, cfg_p, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(mods.image_shape, 2).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(1), mods, B, "cpu")
    s_r, m_r = build_train_step(mods, cfg_r)(state, batch, draws, 0)
    s_p, m_p = build_train_step(mods, cfg_p)(state, batch, draws, 0)
    for k in m_p:
        np.testing.assert_allclose(m_r[k].numpy(), m_p[k].numpy(), rtol=1e-5, err_msg=k)
    assert all(torch.equal(s_r.disc.stats[k], v) for k, v in s_p.disc.stats.items())


# ------ fast_generator ------

def test_fused_conv_gradients_match_naive():
    """The custom backward of both fused convs against autograd of the naive
    forms (rtol 1e-4, atol 1e-4, JAX's test), and against JAX's custom VJPs
    at rtol 1e-4 with an atol of 1e-4 of the gradient's largest element:
    float32 sums of terms as large as that, in XLA's order and not oneDNN's,
    leave a small element of the gradient a few 1e-4 off."""
    rng = np.random.default_rng(5)
    x, k, b = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 18, 10, 6), (4, 4, 6, 3), (3,)))
    x2, k2, b2 = (rng.standard_normal(s).astype(np.float32) for s in
                  ((2, 35, 19, 6), (4, 4, 6, 3), (3,)))

    def naive_up(x_, k_, b_):
        up = x_.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(up, k_, ((1, 1), (1, 1))) + b_

    def naive_rr(x_, k_, b_):
        return _conv(resize_nearest(x_, (56, 30)), k_, ((1, 1), (1, 1))) + b_

    cases = [
        (fused_upsample2_conv4, naive_up, lambda *a: jax_fused_up(*a), (x, k, b)),
        (lambda *a: fused_row_resize_conv4(*a, 56, 30), naive_rr,
         lambda *a: jax_fused_rr(*a, 56, 30), (x2, k2, b2)),
    ]
    for fused, naive, jax_fused, args in cases:
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        out = fused(*leaves)
        g_fast = torch.autograd.grad((out ** 2).sum(), leaves)
        ref = [torch.tensor(a, requires_grad=True) for a in args]
        g_naive = torch.autograd.grad((naive(*ref) ** 2).sum(), ref)
        g_jax = jax.grad(lambda *a: jnp.sum(jax_fused(*a) ** 2), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(out.detach().numpy(), naive(*ref).detach().numpy(),
                                   rtol=1e-4, atol=1e-4)
        for a, n, j in zip(g_fast, g_naive, g_jax):
            np.testing.assert_allclose(a.numpy(), n.numpy(), rtol=1e-4, atol=1e-4)
            j = np.asarray(j)
            np.testing.assert_allclose(a.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_fast_generator_trains():
    """One step with ``train.fast_generator`` (width 0.125, E=2, batch 4)
    against the module path's from the same state and draws: ``gen_loss``
    and ``disc_loss`` within rtol 5e-3."""
    base = ["model.n_experts=2", "train.batch_size=4", "model.generator.width=0.125"]
    cfg_f, cfg_r = load_config(base + ["train.fast_generator=true"]), load_config(base)
    mods = build_moe(cfg_r)
    state = init_state(mods, cfg_r, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"real": torch.randn((4, 56, 30, 1), generator=g).abs(),
             "cond": torch.randn((4, 9), generator=g), "std": torch.full((4, 1), 0.5),
             "intensity": torch.full((4, 1), 10.0), "positions": torch.ones((4, 2))}
    draws = draw_step_noise(torch.Generator().manual_seed(3), mods, 4, "cpu")
    _, m_f = build_train_step(mods, cfg_f)(state, batch, draws, 0)
    _, m_r = build_train_step(mods, cfg_r)(state, batch, draws, 0)
    for k in ("gen_loss", "disc_loss"):
        np.testing.assert_allclose(m_f[k].item(), m_r[k].item(), rtol=5e-3, err_msg=k)


def test_flax_view_is_the_flax_tree_and_differentiable():
    """``flax_view`` of one expert's parameters: ``from_state_dict``'s tree,
    leaf for leaf, through which a loss reaches the parameters."""
    cfg, mods = port_modules("proton")
    params = {k: v[0].clone().requires_grad_() for k, v in
              init_state(mods, cfg, 0, "cpu").gen.params.items()}
    view = flax_view(params)
    for k, a, b in paired(_np(view), from_state_dict(params)):
        assert np.array_equal(a, b), k
    loss = view["Conv_0"]["kernel"][1, 2, 3, 4] * 2.0
    (grad,) = torch.autograd.grad(loss, params["Conv_0.weight"])
    assert grad[4, 3, 1, 2] == 2.0 and grad.abs().sum() == 2.0


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy() for k, v in tree.items()}
