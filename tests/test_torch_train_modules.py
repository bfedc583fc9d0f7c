"""The port's training modules against the JAX package, on the CPU.

- ``SNDense`` and ``SNConv`` against Flax's spectral norm: ``u``, ``sigma``,
  the output and the input gradient over 3 successive train forwards
  (rtol 1e-5); the eval form leaves the stats as they were.
- ``Discriminator`` (train, stats threaded), ``AuxReg`` (eval, and train on
  JAX's dropout keep masks) and ``Generator``: outputs and parameter
  gradients on carried random trees (rtol 1e-4); ``max_pool`` and Flax's
  ``"SAME"`` padding of the residual blocks' identity convs.
- The stacked forwards of ``MoEModules`` against JAX's ``nn.vmap`` stacks.
- ``init_state``: Flax's initialiser statistics.
- ``DeviceLoader`` and ``stratified_batch_order``: index for index JAX's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.data.loader import DeviceLoader as JaxLoader
from zdcsim.data.loader import stratified_batch_order as jax_stratified
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.config import load_config as jax_load_config
from zdcsim.models.layers import SNConv as JaxSNConv
from zdcsim.models.layers import SNDense as JaxSNDense
from zdcsim.models.layers import max_pool as jax_max_pool
from zdcsim.models.proton import AuxReg as JaxAuxReg
from zdcsim.models.proton import Discriminator as JaxDiscriminator
from zdcsim.models.proton import Generator as JaxGenerator
from zdcsim.models.proton import ResidualBlock as JaxResidualBlock
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import from_state_dict, to_state_dict
from zdcsim_torch.data.loader import DeviceLoader, stratified_batch_order
from zdcsim_torch.models import build_moe
from zdcsim_torch.models.layers import SNConv, SNDense, max_pool, same_pads
from zdcsim_torch.models.proton import AuxReg, Discriminator, Generator, ResidualBlock
from zdcsim_torch.train.state import init_state

B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def perturbed(params, seed):
    """A Flax init tree with its constant leaves drawn from a seed: biases
    N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        v = np.array(v, dtype=np.float32)
        if name == "bias":
            return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if name == "scale":
            return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, params)


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}


def assert_trees_close(ours, ref, rtol, what):
    """Leaf by leaf, by relative norm error; a leaf under 1% of the tree's
    norm is held at ``rtol`` of that 1% (a conv bias under a GroupNorm of one
    channel a group has gradient 0 and carries roundoff only)."""
    a, b = flat(ours), flat(ref)
    assert sorted(a) == sorted(b), what
    total = np.sqrt(sum(np.linalg.norm(v) ** 2 for v in b.values()))
    for k in b:
        err = np.linalg.norm(a[k] - b[k])
        assert err <= rtol * max(np.linalg.norm(b[k]), 1e-2 * total), (what, k, err)


def torch_module(module, params):
    """``module`` with the Flax tree ``params`` loaded, every parameter
    requiring grad."""
    module.load_state_dict(to_state_dict(params))
    return module


def param_grads(module):
    return from_state_dict({k: p.grad for k, p in module.named_parameters()})


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

SN_CASES = {
    "dense": (lambda: JaxSNDense(24), lambda: SNDense(40, 24, "SNDense_0"), (B, 40),
              "SNDense_0"),
    "dense_out1": (lambda: JaxSNDense(1), lambda: SNDense(64, 1, "SNDense_0"), (B, 64),
                   "SNDense_0"),
    "conv": (lambda: JaxSNConv(16, (3, 3)), lambda: SNConv(5, 16, 3, "SNConv_0"),
             (B, 9, 7, 5), "SNConv_0"),
}


class SNHolder(nn.Module):
    """One JAX spectral-norm layer under its Flax name, as the discriminator
    holds it."""

    make: object

    @nn.compact
    def __call__(self, x, train):
        return self.make()(x, train=train)


@pytest.mark.parametrize("case", list(SN_CASES))
def test_spectral_norm_matches_flax_over_three_train_forwards(case):
    make_jax, make_port, shape, name = SN_CASES[case]
    rng = np.random.default_rng(len(case))
    holder = SNHolder(make_jax)
    x0 = rng.standard_normal(shape).astype(np.float32)
    v = holder.init(jax.random.PRNGKey(1), jnp.asarray(x0), False)
    params, stats = v["params"], v["batch_stats"]
    layer = make_port()
    layer.load_state_dict(to_state_dict(params[name]))
    ku, ks = layer.stats_keys()
    sub = stats[name]["SpectralNorm_0"]
    port_stats = {ku: torch.from_numpy(np.array(sub[f"{layer.inner}/kernel/u"])),
                  ks: torch.from_numpy(np.array(sub[f"{layer.inner}/kernel/sigma"]))}
    for i in range(3):
        x = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal(np.shape(holder.apply({"params": params, "batch_stats": stats},
                                                      jnp.asarray(x), False))).astype(np.float32)

        def j_loss(xj):
            y, upd = holder.apply({"params": params, "batch_stats": stats}, xj, True,
                                  mutable=["batch_stats"])
            return jnp.sum(y * w), (y, upd)

        (_, (y_ref, upd)), gx_ref = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x))
        xt = torch.tensor(x if x.ndim == 2 else x.transpose(0, 3, 1, 2), requires_grad=True)
        y, new = layer(xt, port_stats, True)
        (y * torch.from_numpy(w if w.ndim == 2 else w.transpose(0, 3, 1, 2))).sum().backward()
        y_np = y.detach().numpy() if y.ndim == 2 else y.detach().numpy().transpose(0, 2, 3, 1)
        gx = xt.grad.numpy() if x.ndim == 2 else xt.grad.numpy().transpose(0, 2, 3, 1)
        stats = upd["batch_stats"]
        sub = stats[name]["SpectralNorm_0"]
        np.testing.assert_allclose(new[ku].numpy(), np.asarray(sub[f"{layer.inner}/kernel/u"]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"u, forward {i}")
        np.testing.assert_allclose(new[ks].numpy(), np.asarray(sub[f"{layer.inner}/kernel/sigma"]),
                                   rtol=1e-5, err_msg=f"sigma, forward {i}")
        np.testing.assert_allclose(y_np, np.asarray(y_ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gx, np.asarray(gx_ref), rtol=1e-5, atol=1e-6)
        assert np.linalg.norm(new[ku].numpy()) == pytest.approx(1.0, rel=1e-5)
        port_stats = new
    # the eval form runs the iteration but hands back the stats it was given
    with torch.no_grad():
        y_eval, same = layer(xt.detach(), port_stats, False)
    assert all(same[k] is port_stats[k] for k in (ku, ks))
    y_ref_eval = holder.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    np.testing.assert_allclose(
        y_eval.numpy() if y_eval.ndim == 2 else y_eval.numpy().transpose(0, 2, 3, 1),
        np.asarray(y_ref_eval), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the proton family's modules
# ---------------------------------------------------------------------------

def disc_inputs(seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((B, 56, 30, 1)) * 3).astype(np.float32),
            rng.standard_normal((B, 9)).astype(np.float32))


def test_discriminator_train_forward_and_gradients_match_jax():
    """Two train forwards threading the stats, as the step does; scores,
    latents, the stats after each, and the parameter gradients of a
    weighted sum of both forwards' outputs."""
    img, cond = disc_inputs(0)
    img2, _ = disc_inputs(1)
    jd = JaxDiscriminator()
    v = jax.jit(lambda k: jd.init(k, jnp.asarray(img), jnp.asarray(cond), False))(
        jax.random.PRNGKey(2))
    params, stats0 = perturbed(v["params"], 3), v["batch_stats"]
    rng = np.random.default_rng(4)
    ws, wl = rng.standard_normal((2, B, 1)).astype(np.float32), rng.standard_normal(
        (2, B, 64)).astype(np.float32)

    def j_loss(p):
        (s1, l1), st1 = jd.apply({"params": p, "batch_stats": stats0}, jnp.asarray(img),
                                 jnp.asarray(cond), True, mutable=["batch_stats"])
        (s2, l2), st2 = jd.apply({"params": p, **st1}, jnp.asarray(img2), jnp.asarray(cond),
                                 True, mutable=["batch_stats"])
        loss = jnp.sum(s1 * ws[0]) + jnp.sum(l1 * wl[0]) + jnp.sum(s2 * ws[1]) + jnp.sum(
            l2 * wl[1])
        return loss, (s1, l1, s2, l2, st2["batch_stats"])

    grads, (s1, l1, s2, l2, st2) = jax.jit(jax.grad(j_loss, has_aux=True))(params)
    d = torch_module(Discriminator(), params)
    t_stats = {f"{a}|{b}|{c}": torch.from_numpy(np.array(x)) for a, sub in stats0.items()
               for b, sub2 in sub.items() for c, x in sub2.items()}
    o1, lat1, st = d(torch.from_numpy(img), torch.from_numpy(cond), t_stats, True)
    o2, lat2, st = d(torch.from_numpy(img2), torch.from_numpy(cond), st, True)
    loss = ((o1 * torch.from_numpy(ws[0])).sum() + (lat1 * torch.from_numpy(wl[0])).sum()
            + (o2 * torch.from_numpy(ws[1])).sum() + (lat2 * torch.from_numpy(wl[1])).sum())
    loss.backward()
    for ours, ref in ((o1, s1), (lat1, l1), (o2, s2), (lat2, l2)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    for k, t in st.items():
        a, b, c = k.split("|")
        np.testing.assert_allclose(t.numpy(), np.asarray(st2[a][b][c]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert_trees_close(param_grads(d), grads, 1e-4, "discriminator grads")


def test_discriminator_flattens_in_nhwc_order():
    """``SNDense_0``'s kernel rows are JAX's NHWC features then the
    conditions: 16 * 12 * 12 + 9 = 2313 inputs."""
    assert Discriminator().SNDense_0.Dense_0.weight.shape == (128, 2313)


@pytest.mark.parametrize("train", [False, True])
def test_aux_reg_matches_jax(train):
    """Eval, and train on JAX's own dropout keep masks (the nonzero outputs
    of its ``Dropout`` layers): outputs and parameter gradients."""
    img, _ = disc_inputs(5)
    ja = JaxAuxReg()
    v = jax.jit(lambda k: ja.init({"params": k, "dropout": k}, jnp.asarray(img), False))(
        jax.random.PRNGKey(6))
    params = perturbed(v["params"], 8)
    w = np.random.default_rng(9).standard_normal((B, 2)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(10)}
    keep = None
    if train:
        _, inter = ja.apply({"params": params}, jnp.asarray(img), True, rngs=rngs,
                            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
                            mutable=["intermediates"])
        keep = tuple(torch.from_numpy(np.asarray(inter["intermediates"][f"Dropout_{i}"]
                                                 ["__call__"][0]) != 0) for i in range(2))
        assert 0.5 < keep[0].float().mean() < 0.9
    grads, out = jax.jit(jax.grad(lambda p: (lambda y: (jnp.sum(y * w), y))(
        ja.apply({"params": p}, jnp.asarray(img), train, rngs=rngs)), has_aux=True))(params)
    a = torch_module(AuxReg(), params)
    y = a(torch.from_numpy(img), keep)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-6)
    assert_trees_close(param_grads(a), grads, 1e-4, "aux grads")


@pytest.mark.parametrize("width", [0.125, 0.25])
def test_generator_forward_and_gradients_match_jax(width):
    rng = np.random.default_rng(11)
    noise, cond = (rng.standard_normal((B, 10)).astype(np.float32),
                   rng.standard_normal((B, 9)).astype(np.float32))
    jg = JaxGenerator(width=width)
    params = perturbed(jax.jit(lambda k: jg.init(k, jnp.asarray(noise), jnp.asarray(cond),
                                                 False))(jax.random.PRNGKey(12))["params"], 13)
    w = rng.standard_normal((B, 56, 30, 1)).astype(np.float32)
    grads, out = jax.jit(jax.grad(lambda p: (lambda y: (jnp.sum(y * w), y))(
        jg.apply({"params": p}, jnp.asarray(noise), jnp.asarray(cond), True)), has_aux=True))(
        params)
    g = torch_module(Generator(width=width), params)
    y = g(torch.from_numpy(noise), torch.from_numpy(cond))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-5)
    assert_trees_close(param_grads(g), grads, 1e-4, "generator grads")


@pytest.mark.parametrize("n,k,s", [(26, 1, 2), (13, 1, 2), (12, 1, 2), (6, 1, 2), (7, 3, 2),
                                   (10, 4, 3), (5, 5, 1), (9, 2, 2)])
def test_same_pads_match_flax(n, k, s):
    assert same_pads(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("shape,strides,feat", [((B, 26, 13, 32), 2, 32),
                                                ((B, 12, 6, 32), 2, 64),
                                                ((B, 9, 7, 16), 1, 16)])
def test_residual_block_matches_jax(shape, strides, feat):
    """The aux regressor's blocks at the proton shapes (their identity 1x1
    stride-2 conv pads zero under ``"SAME"``), and one without projection."""
    x = np.random.default_rng(14).standard_normal(shape).astype(np.float32)
    jr = JaxResidualBlock(feat, kernel_size=5, strides=strides)
    params = perturbed(jr.init(jax.random.PRNGKey(15), jnp.asarray(x))["params"], 16)
    ref = np.asarray(jr.apply({"params": params}, jnp.asarray(x)))
    r = torch_module(ResidualBlock(shape[-1], feat, 5, strides), params)
    out = r(torch.from_numpy(x.transpose(0, 3, 1, 2))).detach().numpy().transpose(0, 2, 3, 1)
    assert r.project == (strides != 1 or shape[-1] != feat)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window,strides", [((2, 2), None), ((2, 1), None), ((2, 2), (1, 1))])
def test_max_pool_matches_flax(window, strides):
    x = np.random.default_rng(17).standard_normal((B, 25, 13, 3)).astype(np.float32)
    ref = np.asarray(jax_max_pool(jnp.asarray(x), window, strides))
    ours = max_pool(torch.from_numpy(x.transpose(0, 3, 1, 2)), window, strides)
    np.testing.assert_array_equal(ours.numpy().transpose(0, 2, 3, 1), ref)


# ---------------------------------------------------------------------------
# stacked forwards, init, loader
# ---------------------------------------------------------------------------

def test_stacked_forwards_match_jax_stacks():
    """``MoEModules.generate`` broadcasts noise and conditions to every
    expert; ``discriminate`` and ``regress`` take each expert's own slice
    (``in_axes=(0, None, None)`` and ``(0, None)``)."""
    from zdcsim_torch.convert import _train_stats_from_jax

    ov = ["model.n_experts=2", "model.generator.width=0.125"]
    jm = jax_build_moe(jax_load_config(overrides=ov))
    pm = build_moe(load_config(ov))
    rng = np.random.default_rng(19)
    noise, cond = (rng.standard_normal((B, 10)).astype(np.float32),
                   rng.standard_normal((B, 9)).astype(np.float32))
    img_e = jnp.zeros((2, B, 56, 30, 1))
    keys = {"params": jax.random.PRNGKey(18), "dropout": jax.random.PRNGKey(18)}
    gen_p = jax.jit(lambda: jm.generator.init(keys, jnp.asarray(noise), jnp.asarray(cond),
                                              False))()["params"]
    dv = jax.jit(lambda: jm.discriminator.init(keys, img_e, jnp.asarray(cond), False))()
    aux_p = jax.jit(lambda: jm.aux_reg.init(keys, img_e, False))()["params"]
    port = lambda t: to_state_dict(t, stacked=True)  # noqa: E731
    fakes = np.array(jax.jit(lambda: jm.generator.apply(
        {"params": gen_p}, jnp.asarray(noise), jnp.asarray(cond), True))())
    ours = pm.generate(port(gen_p), torch.from_numpy(noise), torch.from_numpy(cond))
    np.testing.assert_allclose(ours.numpy(), fakes, rtol=1e-4, atol=1e-5)
    (sc, lat), st = jax.jit(lambda: jm.discriminator.apply(
        dv, jnp.asarray(fakes), jnp.asarray(cond), True, mutable=["batch_stats"]))()
    sc_p, lat_p, st_p = pm.discriminate(
        port(dv["params"]), _train_stats_from_jax({"batch_stats": dv["batch_stats"]}, "cpu"),
        torch.from_numpy(fakes), torch.from_numpy(cond))
    np.testing.assert_allclose(sc_p.detach().numpy(), np.asarray(sc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lat_p.detach().numpy(), np.asarray(lat), rtol=1e-4, atol=1e-5)
    ref_u = np.asarray(st["batch_stats"]["SNDense_0"]["SpectralNorm_0"]["Dense_0/kernel/u"])
    np.testing.assert_allclose(st_p["SNDense_0|SpectralNorm_0|Dense_0/kernel/u"].numpy(), ref_u,
                               rtol=1e-4, atol=1e-6)
    aux = np.asarray(jax.jit(lambda: jm.aux_reg.apply({"params": aux_p}, jnp.asarray(fakes),
                                                      False))())
    np.testing.assert_allclose(pm.regress(port(aux_p), torch.from_numpy(fakes)).detach()
                               .numpy(), aux, rtol=1e-4, atol=1e-5)


def test_init_state_has_flax_initialiser_statistics():
    """Kernels ``lecun_normal`` (std within 10% of ``1/sqrt(fan_in)`` on the
    leaves of 4096 elements or more, within [-2, 2] of it), biases 0, norm
    scales 1, SN ``u`` N(0, 1) and ``sigma`` 1; Adam's moments 0."""
    cfg = load_config(["model.generator.width=0.25"])
    mods = build_moe(cfg)
    s = init_state(mods, cfg, seed=0, device="cpu")
    checked = 0
    for comp in (s.gen, s.disc, s.aux):
        for k, v in comp.params.items():
            if k.endswith(".bias"):
                assert torch.count_nonzero(v) == 0, k
            elif v.ndim == 2:  # norm scale, stacked
                assert torch.all(v == 1), k
            else:
                fan_in = int(np.prod(v.shape[2:]))
                bound = 2 / np.sqrt(fan_in) / 0.87962566103423978
                assert v.abs().max() <= bound * (1 + 1e-6), k
                if v[0].numel() >= 4096:
                    std = v.std().item()
                    assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (k, std * np.sqrt(fan_in))
                    checked += 1
            assert all(torch.count_nonzero(m[k]) == 0 for m in (comp.opt_state.mu,
                                                                comp.opt_state.nu))
    assert checked >= 8
    u = [v for k, v in s.disc.stats.items() if k.endswith("/u")]
    sig = [v for k, v in s.disc.stats.items() if k.endswith("/sigma")]
    assert len(u) == len(sig) == 5 and all(torch.all(x == 1) for x in sig)
    allu = torch.cat([x.flatten() for x in u])
    assert abs(allu.mean().item()) < 0.15 and abs(allu.std().item() - 1) < 0.1
    assert s.step.item() == 0 and s.gen.opt_state.count.dtype == torch.int32
    for k, v in s.gen.params.items():
        assert torch.equal(s.ema_gen_params[k], v) and s.ema_gen_params[k] is not v
    # experts are drawn independently
    k0 = "MLPBlock_1.Dense_0.weight"
    assert not torch.equal(s.gen.params[k0][0], s.gen.params[k0][1])


@pytest.mark.parametrize("stratify", [False, True])
def test_device_loader_matches_jax_index_for_index(stratify):
    rng = np.random.default_rng(20)
    n = 37
    arrays = {"real": rng.random((n, 4, 3, 1)).astype(np.float32),
              "cond": rng.standard_normal((n, 9)).astype(np.float32)}
    labels = rng.integers(0, 3, n) if stratify else None
    ours = DeviceLoader(arrays, 8, seed=5, stratify_labels=labels, device="cpu")
    ref = JaxLoader(arrays, 8, seed=5, stratify_labels=labels)
    assert len(ours) == len(ref) == 4  # the remainder is dropped
    for ep in (0, 3):
        batches = list(ours.epoch(ep))
        for b_ours, b_ref in zip(batches, ref.epoch(ep)):
            for k in arrays:
                np.testing.assert_array_equal(b_ours[k].numpy(), np.asarray(b_ref[k]))
        assert len(batches) == 4
    plain = DeviceLoader(arrays, 8, shuffle=False, device="cpu")
    np.testing.assert_array_equal(next(plain.epoch(0))["cond"].numpy(), arrays["cond"][:8])


@pytest.mark.parametrize("stratified", ["false", "true"])
def test_make_loaders_match_jax(stratified):
    """``train.stratified_batches`` orders the train side by the expert
    labels; the test side keeps storage order at ``min(batch, n_test)``."""
    from types import SimpleNamespace

    from zdcsim.data.loader import make_loaders as jax_make_loaders
    from zdcsim_torch.data.loader import make_loaders

    rng = np.random.default_rng(22)
    side = lambda n: {f"{k}": v for k, v in (  # noqa: E731
        ("x", rng.random((n, 4, 3)).astype(np.float32)),
        ("y", rng.standard_normal((n, 9)).astype(np.float32)),
        ("std", rng.random((n, 1)).astype(np.float32)),
        ("intensity", rng.random((n, 1)).astype(np.float32)),
        ("positions", rng.random((n, 2)).astype(np.float32)))}
    tr, te = side(40), side(6)
    split = SimpleNamespace(**{f"{k}_train": v for k, v in tr.items()},
                            **{f"{k}_test": v for k, v in te.items()},
                            expert_number_train=rng.integers(0, 3, 40))
    ov = ["train.batch_size=8", "train.seed=3", f"train.stratified_batches={stratified}"]
    ours = make_loaders(load_config(ov), split, device="cpu")
    ref = jax_make_loaders(jax_load_config(overrides=ov), split)
    for o, r in zip(ours, ref):
        assert len(o) == len(r)
        for bo, br in zip(o.epoch(1), r.epoch(1)):
            np.testing.assert_array_equal(bo["cond"].numpy(), np.asarray(br["cond"]))
    assert ours[1].batch_size == 6


def test_stratified_order_matches_jax():
    labels = np.random.default_rng(21).integers(0, 4, 200)
    ours = stratified_batch_order(labels, 16, np.random.default_rng((1, 2)))
    ref = jax_stratified(labels, 16, np.random.default_rng((1, 2)))
    np.testing.assert_array_equal(ours, ref)
    assert sorted(ours.tolist()) == list(range(200))
