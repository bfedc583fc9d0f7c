"""The switch train step (``train.dispatch=switch``) and ``tiled_switch_apply``
of the port against ``zdcsim``'s, on the CPU.

``tiled_switch_apply`` is held against JAX's on a random pytree, values and
gradients. The switch step is held against JAX's switch step from one JAX
state carried across, on JAX's draws: the Gumbel noise and the generator
noises as ``zdcsim/train/step.py:530-545`` draws them, and the aux
regressor's dropout keep masks rebuilt per row from JAX's per-(expert,
chunk) draws (``:595-603``; :func:`switch_draws`). Two systems, as
``tests/test_torch_train_step.py``: ``build_tiny_moe`` (E=3) and the proton
modules at ``width=0.125`` (E=2), batch 8, tile 4, at that file's
tolerances. Then the port's switch step against its dense step, at the
tolerances of JAX's own test (``tests/test_train_step.py:237-281``).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (
    B, LRS, assert_metrics_match, jax_modules, leaves, make_batch, paired, port_modules,
)
from zdcsim.inference.switch_dispatch import tiled_switch_apply as jax_apply
from zdcsim.train.state import init_state_jit
from zdcsim.train.step import build_train_step as jax_build_train_step
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax, train_state_to_jax
from zdcsim_torch.inference.switch_dispatch import _chunk_table, tiled_switch_apply
from zdcsim_torch.models.testing import build_tiny_moe
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


# ------ tiled_switch_apply ------

def _experts(lib, weights):
    """Per-expert closures of a two-leaf output: ``(tanh(x W_e) * c, sum(x^2) * (e + 1))``."""
    def make(e):
        def fn(chunk):
            x, c = chunk["x"], chunk["c"]
            return lib.tanh(x @ weights[e]) * c, (x * x).sum(1) * (e + 1.0)

        return fn

    return [make(e) for e in range(len(weights))]


@pytest.mark.parametrize("remat", [False, True])
def test_tiled_switch_apply_matches_jax(remat):
    """Values and gradients (of the weights and of the inputs) against JAX's
    on a batch of 16, tile 4: expert 0 routed no sample, expert 1 exactly a
    tile, expert 2 the rest (a partial last tile, whose pad lanes must add
    nothing to the gradients)."""
    rng = np.random.default_rng(0)
    b, d, e = 16, 5, 3
    idx = rng.permutation(np.array([1] * TILE + [2] * (b - TILE)))
    x, c, w, gy, gz = (rng.standard_normal(s).astype(np.float32)
                       for s in ((b, d), (b, 1), (e, d, 2), (b, 2), (b,)))

    def jax_loss(w_, x_):
        y, z = jax_apply(_experts(jnp, w_), jnp.asarray(idx), {"x": x_, "c": jnp.asarray(c)},
                         tile=TILE, remat=remat)
        return (y * gy).sum() + (z * gz).sum(), (y, z)

    (_, (y_ref, z_ref)), (dw_ref, dx_ref) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(w), jnp.asarray(x))
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y, z = tiled_switch_apply(_experts(torch, list(wt.unbind(0))), torch.from_numpy(idx),
                              {"x": xt, "c": torch.from_numpy(c)}, tile=TILE, remat=remat)
    dw, dx = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                                 + (z * torch.from_numpy(gz)).sum(), (wt, xt))
    for ours, ref in ((y, y_ref), (z, z_ref), (dw, dw_ref), (dx, dx_ref)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert float(dw[0].abs().max()) == 0.0  # the expert of no sample gets no gradient


def test_tiled_switch_apply_runs_each_used_chunk_once():
    """The chunk table: used chunks belong to one expert each; the real
    lanes cover every row once; the unused chunks (JAX's dummy-row chunks)
    are not run."""
    idx = torch.tensor([2, 2, 1, 2, 2, 1, 2, 2])
    rows, e_k, used, real = _chunk_table(idx, 3, 2, True)
    assert rows.shape == (8 // 2 + 3, 2)
    assert sorted(rows[used[:, None] & real].tolist()) == list(range(8))
    assert all(bool((idx[rows[k][real[k]]] == e_k[k]).all()) for k in range(len(e_k)) if used[k])
    calls = []

    def fn(e):
        return lambda ch: (calls.append(e), ch["x"] * (e + 1))[1]

    out = tiled_switch_apply([fn(0), fn(1), fn(2)], idx, {"x": torch.arange(8.0)}, tile=2)
    assert out.tolist() == [0.0, 3.0, 4.0, 9.0, 12.0, 10.0, 18.0, 21.0]
    assert sorted(calls) == [1, 2, 2, 2]


def test_tiled_switch_apply_rejects_indivisible_tile():
    with pytest.raises(ValueError, match="multiple of tile"):
        tiled_switch_apply([lambda ch: ch["x"]], torch.zeros(6, dtype=torch.long),
                           {"x": torch.zeros(6)}, tile=4)


# ------ the switch step against JAX's ------

def switch_draws(mods, state, batch, key):
    """The draws of JAX's switch step on ``key`` as the port takes them: the
    routing rebuilt from the state's router and the Gumbel noise, the chunk
    table from it (``_chunk_table``, the one JAX's ``chunk_rows`` computes),
    and each real row's aux keep masks those of its lane in JAX's draw for
    its (expert, chunk), ``fold_in(fold_in(k_aux, e), first row of the
    chunk)``, captured from JAX's single aux regressor. (The temperature
    scales the logits and leaves the argmax as it is.)"""
    k_gumbel, k_n1, k_n2, _, _, k_aux = jax.random.split(key, 6)
    e, nd = mods.n_experts, mods.noise_dim
    gumbel = jax.random.gumbel(k_gumbel, (B, e))
    _, logits = mods.router.apply({"params": state.router.params}, jnp.asarray(batch["cond"]))
    idx = np.array(jnp.argmax(logits + gumbel, axis=-1))
    rows, e_k, used, real = _chunk_table(torch.from_numpy(idx), e, TILE, True)
    keep = None
    img = jax.random.uniform(jax.random.PRNGKey(5), (TILE, *mods.image_shape, 1))
    capture = jax.jit(lambda p, rng: mods.aux_reg_single.apply(  # one compile for every chunk
        {"params": p}, img, True, rngs={"dropout": rng},
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
        mutable=["intermediates"])[1])
    for k in np.flatnonzero(used.numpy()):
        ek, r, lanes = int(e_k[k]), rows[k].numpy(), real[k].numpy()
        params = jax.tree_util.tree_map(lambda v: v[ek], state.aux.params)
        rng = jax.random.fold_in(jax.random.fold_in(k_aux, ek), int(r[0]))
        caught = capture(params, rng).get("intermediates", {})
        masks = [np.asarray(caught[f"Dropout_{i}"]["__call__"][0]) != 0
                 for i in range(len(caught))]
        if keep is None:
            keep = [np.zeros((B, *m.shape[1:]), bool) for m in masks]
        for kk, m in zip(keep, masks):
            kk[r[lanes]] = m[lanes]
    return {"gumbel": torch.from_numpy(np.array(gumbel)),
            "noise_1": torch.from_numpy(np.array(jax.random.normal(k_n1, (B, nd)))),
            "noise_2": torch.from_numpy(np.array(jax.random.normal(k_n2, (B, nd)))),
            "aux_keep": tuple(torch.from_numpy(k) for k in keep or [])}


class SwitchRun:
    """One system's JAX state, two chained JAX switch steps, and the port's
    switch steps on the same draws: from the carried state, and from the
    carried state of JAX's first step."""

    def __init__(self, name):
        self.name = name
        cfg, mods = jax_modules(name, SWITCH)
        state = init_state_jit(mods, cfg, jax.random.PRNGKey(3))
        self.before = train_state_to_jax(train_state_from_jax(state, "cpu"))
        pcfg, self.pmods = port_modules(name, SWITCH)
        self.port_step = build_train_step(self.pmods, pcfg)
        assert self.port_step.switch
        step = jax_build_train_step(mods, cfg)
        self.jax, self.port, self.draws = [], [], []
        for t in range(2):
            batch = make_batch(mods.image_shape, 11 + t)
            key = jax.random.PRNGKey(17 + t)
            draws = switch_draws(mods, state, batch, key)
            tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
            port = self.port_step(train_state_from_jax(state, "cpu"), tbatch, draws, t)
            state, met = step(jax.tree_util.tree_map(jnp.copy, state),
                              {k: jnp.asarray(v) for k, v in batch.items()}, key,
                              jnp.asarray(t, jnp.int32))
            self.port.append(port)
            self.jax.append((train_state_to_jax(train_state_from_jax(state, "cpu")),
                             {k: np.asarray(v) for k, v in met.items()}))
            self.draws.append(draws)


@pytest.fixture(scope="module", params=["tiny", "proton"])
def run(request):
    return SwitchRun(request.param)


@pytest.mark.parametrize("t", [0, 1])
def test_switch_metrics_match_jax(run, t):
    """Each of two chained steps from JAX's state before it."""
    assert_metrics_match(run.port[t][1], run.jax[t][1])


def test_switch_draws_are_one_mask_per_row(run):
    keep = run.draws[0]["aux_keep"]
    assert [tuple(k.shape) for k in keep] == [(B, *s) for s in run.pmods.aux_reg.dropout_shapes]
    ours = draw_step_noise(torch.Generator().manual_seed(0), run.pmods, B, "cpu", switch=True)
    assert [k.shape for k in ours["aux_keep"]] == [k.shape for k in keep]


@pytest.mark.parametrize("t", [0, 1])
def test_switch_state_matches_jax(run, t):
    """Spectral-norm stats per expert by norm, Adam's moments by relative
    norm per leaf, parameters at ``2 lr`` and the EMA's change at rtol 1e-4,
    counts equal: the tolerances of ``tests/test_torch_train_step.py``."""
    ref, ours = run.jax[t][0], train_state_to_jax(run.port[t][0])
    for k, a, b in paired(ours["disc"]["stats"], ref["disc"]["stats"]):
        err = np.linalg.norm((a - b).reshape(len(b), -1), axis=1)
        assert np.all(err <= 1e-4 * np.linalg.norm(b.reshape(len(b), -1), axis=1)), k
    for comp in ("gen", "disc", "aux", "router"):
        assert ours[comp]["opt_state"]["count"] == ref[comp]["opt_state"]["count"]
        for moment in ("mu", "nu"):
            pairs = paired(ours[comp]["opt_state"][moment], ref[comp]["opt_state"][moment])
            total = np.sqrt(sum(np.linalg.norm(b) ** 2 for _, _, b in pairs))
            for k, a, b in pairs:
                assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b), 1e-2 * total), (
                    comp, moment, k)
        for k, a, b in paired(ours[comp]["params"], ref[comp]["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LRS[comp], err_msg=f"{comp} {k}")
    prev = run.before if t == 0 else run.jax[0][0]
    e0s = dict(leaves(prev["ema_gen_params"]))
    for k, a, b in paired(ours["ema_gen_params"], ref["ema_gen_params"]):
        np.testing.assert_allclose(a - e0s[k], b - e0s[k], rtol=1e-4,
                                   atol=0.01 * 2 * LRS["gen"], err_msg=k)
    assert ours["step"] == ref["step"] == t + 1


def test_switch_refuses_dense_keep_masks():
    """The dense step's ``[E, B, ...]`` keep masks are the wrong draws here."""
    cfg, mods = port_modules("proton", SWITCH)
    dense = draw_step_noise(torch.Generator().manual_seed(0), mods, B, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(mods.image_shape, 11).items()}
    with pytest.raises(ValueError, match="one aux keep mask per row"):
        build_train_step(mods, cfg)(init_state(mods, cfg, 0, "cpu"), batch, dense, 0)


def test_switch_refuses_generator_batch_statistics():
    """JAX's refusal (``zdcsim/train/step.py:514-522``): per-sub-batch
    BatchNorm statistics need the dense step."""
    import dataclasses

    cfg, mods = port_modules("proton", SWITCH)
    state = init_state(mods, cfg, 0, "cpu")
    state = dataclasses.replace(state, gen=dataclasses.replace(
        state.gen, stats={"MaskedBatchNorm_0|mean": torch.zeros(2, 4)}))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(mods.image_shape, 11).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(0), mods, B, "cpu", switch=True)
    with pytest.raises(ValueError, match="requires stats-free generator/aux"):
        build_train_step(mods, cfg)(state, batch, draws, 0)


# ------ the switch step against the dense step (JAX's tests/test_train_step.py:237) ------

SHAPE = (8, 6)


def tiny_cfg(*over, b=16):
    return load_config(["model.n_experts=3", f"train.batch_size={b}",
                        "model.router.differentiable_gan_term=false", *over])


def torch_batch(seed, b=16):
    g = torch.Generator().manual_seed(seed)
    return {"real": torch.randn((b, *SHAPE, 1), generator=g).abs(),
            "cond": torch.randn((b, 9), generator=g),
            "std": torch.rand((b, 1), generator=g),
            "intensity": torch.rand((b, 1), generator=g) * 100,
            "positions": torch.rand((b, 2), generator=g) * 6}


def test_switch_step_matches_dense():
    """Losses and metrics within rtol 2e-4 / atol 1e-5, the shares equal,
    every parameter within rtol 2e-3 / atol 2e-5, from one state on one
    set of draws (the tiny modules have no dropout and no spectral norm, so
    the two differ by rounding only)."""
    cfg_d, cfg_s = tiny_cfg(), tiny_cfg("train.dispatch=switch", f"train.dispatch_tile={TILE}")
    mods = build_tiny_moe(cfg_d, SHAPE)
    state = init_state(mods, cfg_d, 0, "cpu")
    draws = draw_step_noise(torch.Generator().manual_seed(4), mods, 16, "cpu", switch=True)
    batch = torch_batch(3)
    sd, md = build_train_step(mods, cfg_d)(state, batch, draws, 0)
    ss, ms = build_train_step(mods, cfg_s)(state, batch, draws, 0)
    for k in ("gen_loss", "disc_loss", "div_loss", "intensity_loss", "aux_reg_loss",
              "router_loss", "gan_loss"):
        np.testing.assert_allclose(ms[k].numpy(), md[k].numpy(), rtol=2e-4, atol=1e-5, err_msg=k)
    assert torch.equal(md["n_choosen_experts_mean_epoch"], ms["n_choosen_experts_mean_epoch"])
    for name in ("gen", "disc", "aux", "router"):
        a, b = getattr(sd, name).params, getattr(ss, name).params
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=f"{name} {k}")


def test_switch_two_steps_stay_close_to_dense():
    """Two chained steps (tile 8): ``gen_loss`` and ``disc_loss`` within rtol
    1e-3 of the dense step's."""
    cfg_d, cfg_s = tiny_cfg(), tiny_cfg("train.dispatch=switch", "train.dispatch_tile=8")
    mods = build_tiny_moe(cfg_d, SHAPE)
    step_d, step_s = build_train_step(mods, cfg_d), build_train_step(mods, cfg_s)
    sd = ss = init_state(mods, cfg_d, 0, "cpu")
    for t in range(2):
        batch = torch_batch(10 + t)
        draws = draw_step_noise(torch.Generator().manual_seed(20 + t), mods, 16, "cpu",
                                switch=True)
        sd, md = step_d(sd, batch, draws, t)
        ss, ms = step_s(ss, batch, draws, t)
    for k in ("gen_loss", "disc_loss"):
        np.testing.assert_allclose(ms[k].numpy(), md[k].numpy(), rtol=1e-3, err_msg=k)


def test_switch_with_one_expert_is_the_dense_step():
    """JAX's rule: with E=1 ``train.dispatch=switch`` builds the dense step."""
    cfg = load_config(["model.n_experts=1", "train.dispatch=switch"])
    assert not build_train_step(build_tiny_moe(cfg, SHAPE), cfg).switch
