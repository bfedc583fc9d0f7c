"""The neutron family's training modules against the JAX package, on the CPU.

- ``MaskedBatchNorm``'s training form against Flax's: a routing mask, no
  mask, an empty mask, ``[B, F]`` and NCHW inputs, bfloat16 input; the
  output (unrouted rows exactly zero), the input and parameter gradients and
  the new running statistics (rtol 1e-4; bfloat16 outputs within two of its
  ulps).
- ``GeneratorNeutron`` (``norm`` batch, group, none) and ``GeneratorNeutronV2``
  in training form on the keep masks of JAX's own ``Dropout`` layers (the
  nonzero outputs, captured with ``capture_intermediates``): outputs, new
  statistics and parameter gradients (rtol 1e-4).
- ``DiscriminatorNeutron`` over 3 train forwards threading the
  spectral-norm stats; ``AuxRegNeutron`` in each norm.
- The masked stacks of ``MoEModules`` (``model.norm=batch``) against JAX's
  ``generator_masked`` / ``aux_reg_masked``.
- ``init_state`` of the neutron family against JAX's tree: the same leaves
  and shapes, BatchNorm ``mean`` 0 and ``var`` 1.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_modules import assert_trees_close, param_grads, perturbed, torch_module
from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from zdcsim.models.neutron import AuxRegNeutron as JaxAuxRegNeutron
from zdcsim.models.neutron import DiscriminatorNeutron as JaxDiscriminatorNeutron
from zdcsim.models.neutron import GeneratorNeutron as JaxGeneratorNeutron
from zdcsim.models.neutron import GeneratorNeutronV2 as JaxGeneratorNeutronV2
from zdcsim.train.state import init_state_jit
from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config
from zdcsim_torch.convert import (
    _train_stats_from_jax, to_state_dict, train_state_from_jax, train_state_to_jax,
)
from zdcsim_torch.models import build_moe, expert_slices, stack_trees
from zdcsim_torch.models.layers import MaskedBatchNorm
from zdcsim_torch.models.neutron import (
    AuxRegNeutron, DiscriminatorNeutron, GeneratorNeutron, GeneratorNeutronV2,
)
from zdcsim_torch.train.state import init_state

B = 4
MASK = np.array([1.0, 1.0, 0.0, 1.0], np.float32)  # row 2 routed elsewhere


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def nchw(a):
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def dropout_keep(inter):
    """The keep masks of the captured ``Dropout`` outputs (``Dropout_0..``),
    as bool tensors."""
    caught = inter.get("intermediates", {})
    return tuple(torch.from_numpy(np.asarray(caught[f"Dropout_{i}"]["__call__"][0]) != 0)
                 for i in range(len(caught)))


def is_dropout(m, _):
    return isinstance(m, nn.Dropout)


def flat_stats(stats):
    """A Flax ``batch_stats`` tree -> the port's flat ``|``-joined keys."""
    return {k: v.detach() for k, v in
            _train_stats_from_jax({"batch_stats": stats}, "cpu").items()}


def assert_stats_close(ours, ref, what):
    assert sorted(ours) == sorted(ref), what
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# MaskedBatchNorm
# ---------------------------------------------------------------------------

BN_CASES = {
    "mask_dense": ((B, 24), MASK, torch.float32),
    "mask_conv": ((B, 5, 7, 6), MASK, torch.float32),
    "no_mask_conv": ((B, 5, 7, 6), None, torch.float32),
    "empty_mask": ((B, 24), np.zeros(B, np.float32), torch.float32),
    "mask_bf16": ((B, 5, 7, 6), MASK, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_masked_batch_norm_train_matches_jax(case):
    shape, mask, dtype = BN_CASES[case]
    rng = np.random.default_rng(len(case))
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)  # NHWC as JAX's
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    f = shape[-1]
    jbn = JaxMaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), None, False)
    params = {"scale": (1 + 0.1 * rng.standard_normal(f)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(f)).astype(np.float32)}
    old = {"mean": (0.3 * rng.standard_normal(f)).astype(np.float32),
           "var": (0.5 + rng.random(f)).astype(np.float32)}
    assert jax.tree_util.tree_structure(v["batch_stats"]) == jax.tree_util.tree_structure(old)
    w = rng.standard_normal(shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def j_loss(p, xj):
        y, upd = jbn.apply({"params": p, "batch_stats": old}, xj.astype(jdt), jmask, True,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd["batch_stats"])

    (g_p, g_x), (y_ref, st_ref) = jax.jit(jax.grad(j_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    bn = MaskedBatchNorm(f)
    bn.weight.data, bn.bias.data = torch.from_numpy(params["scale"]), torch.from_numpy(
        params["bias"])
    bn.running_mean.copy_(torch.from_numpy(old["mean"]))
    bn.running_var.copy_(torch.from_numpy(old["var"]))
    xt = torch.from_numpy(nchw(x)).requires_grad_()
    y, mean, var = bn(xt.to(dtype), True, None if mask is None else torch.from_numpy(mask))
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    (y.float() * torch.from_numpy(nchw(w))).sum().backward()
    y_np, y_ref = nhwc(y.detach().float().numpy()), np.asarray(y_ref.astype(jnp.float32))
    if dtype == torch.bfloat16:  # float32 statistics, the output rounded to bfloat16
        np.testing.assert_allclose(y_np, y_ref, rtol=2 ** -7, atol=2 ** -7)
    else:
        np.testing.assert_allclose(y_np, y_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(nhwc(xt.grad.numpy()), np.asarray(g_x), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_p["scale"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_p["bias"]), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(st_ref["mean"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(st_ref["var"]), rtol=1e-4, atol=1e-6)
    if mask is not None:  # the unrouted rows come out exactly zero, in both
        off = mask == 0
        assert np.all(y_np[off] == 0) and np.all(y_ref[off] == 0)
    # the buffers are left as they were: the caller keeps the statistics
    assert torch.equal(bn.running_mean, torch.from_numpy(old["mean"]))


# ---------------------------------------------------------------------------
# the generators' training forward
# ---------------------------------------------------------------------------

def gen_inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 10)).astype(np.float32),
            rng.standard_normal((b, 9)).astype(np.float32))


def random_trees(module, args, seed):
    """``(params, batch_stats)`` of ``module``: its Flax init with biases and
    scales drawn (``perturbed``), running statistics drawn (mean N(0, 0.3),
    var 0.5 + U(0, 1))."""
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k}, *args, False))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.3 * rng.standard_normal(a.shape) if path[-1].key == "mean"
                         else 0.5 + rng.random(a.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    return perturbed(v["params"], seed + 1), stats


GEN_CASES = {
    "batch": (lambda: JaxGeneratorNeutron(norm="batch", width=0.125),
              lambda: GeneratorNeutron(norm="batch", width=0.125)),
    "group": (lambda: JaxGeneratorNeutron(norm="group", width=0.125),
              lambda: GeneratorNeutron(norm="group", width=0.125)),
    "none": (lambda: JaxGeneratorNeutron(norm="none", width=0.125),
             lambda: GeneratorNeutron(norm="none", width=0.125)),
    "v2": (lambda: JaxGeneratorNeutronV2(norm="group", width=0.125),
           lambda: GeneratorNeutronV2(norm="group", width=0.125)),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generator_train_forward_matches_jax(case):
    """JAX's train forward on a ``dropout`` key, its keep masks captured, and
    (``norm=batch``) the routing mask ``MASK``: the port's forward on those
    masks gives the same showers, new statistics and parameter gradients."""
    make_jax, make_port = GEN_CASES[case]
    jg = make_jax()
    noise, cond = gen_inputs(1)
    args = (jnp.asarray(noise), jnp.asarray(cond))
    params, stats = random_trees(jg, args, 2)
    masked = case == "batch"
    extra = (jnp.asarray(MASK),) if masked else ()
    rngs = {"dropout": jax.random.PRNGKey(3)}
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _, inter = jax.jit(lambda: jg.apply(variables, *args, True, *extra, rngs=rngs,
                                        capture_intermediates=is_dropout,
                                        mutable=["intermediates", "batch_stats"]))()
    keep = dropout_keep(inter)
    w = np.random.default_rng(4).standard_normal((B, 44, 44, 1)).astype(np.float32)

    def j_loss(p):
        out, upd = jg.apply({**variables, "params": p}, *args, True, *extra, rngs=rngs,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd.get("batch_stats", {}))

    grads, (out_ref, st_ref) = jax.jit(jax.grad(j_loss, has_aux=True))(params)
    g = make_port()
    g.load_state_dict(to_state_dict(params, stats or None))
    if case == "v2":
        assert not keep and not getattr(g, "train_form", False)
        y = g(torch.from_numpy(noise), torch.from_numpy(cond), True)
        new = {}
    else:
        assert [tuple(k.shape[1:]) for k in keep] == [tuple(s) for s in g.dropout_shapes]
        assert 0.7 < float(torch.cat([k[MASK == 1].flatten() for k in keep]).float().mean()) < 0.9
        y, new = g(torch.from_numpy(noise), torch.from_numpy(cond), True, keep,
                   torch.from_numpy(MASK) if masked else None)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out_ref), rtol=1e-4, atol=1e-5)
    assert (np.asarray(out_ref) > 0).mean() > 0.02  # the ReLU leaves pixels to compare
    assert_stats_close(new, flat_stats(st_ref), "generator stats")
    assert bool(new) == masked
    assert_trees_close(param_grads(g), grads, 1e-4, "generator grads")
    if masked:  # the unrouted row's showers are the bias's alone
        assert np.ptp(np.asarray(out_ref)[2]) == 0


# ---------------------------------------------------------------------------
# DiscriminatorNeutron, AuxRegNeutron
# ---------------------------------------------------------------------------

def images(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 44, 44, 1)) * 3).astype(np.float32)


def test_discriminator_neutron_over_three_train_forwards():
    """Three train forwards threading the spectral-norm stats: scores,
    latents, the stats after each, and the parameter gradients of a
    weighted sum of the outputs. 16 * 9 * 9 + 9 = 1305 inputs of
    ``SNDense_0``."""
    cond = gen_inputs(5)[1]
    imgs = [images(6 + i) for i in range(3)]
    jd = JaxDiscriminatorNeutron()
    v = jax.jit(lambda k: jd.init(k, jnp.asarray(imgs[0]), jnp.asarray(cond), False))(
        jax.random.PRNGKey(7))
    params, stats0 = perturbed(v["params"], 8), v["batch_stats"]
    rng = np.random.default_rng(9)
    ws = rng.standard_normal((3, B, 1)).astype(np.float32)
    wl = rng.standard_normal((3, B, 64)).astype(np.float32)

    def j_loss(p):
        st, loss, outs = {"batch_stats": stats0}, 0.0, []
        for i in range(3):
            (s, lat), st = jd.apply({"params": p, **st}, jnp.asarray(imgs[i]),
                                    jnp.asarray(cond), True, mutable=["batch_stats"])
            loss = loss + jnp.sum(s * ws[i]) + jnp.sum(lat * wl[i])
            outs.append((s, lat, st["batch_stats"]))
        return loss, outs

    grads, outs = jax.jit(jax.grad(j_loss, has_aux=True))(params)
    d = torch_module(DiscriminatorNeutron(), params)
    assert d.SNDense_0.Dense_0.weight.shape == (128, 1305)
    st, loss = flat_stats(stats0), 0.0
    for i, (s_ref, l_ref, st_ref) in enumerate(outs):
        s, lat, st = d(torch.from_numpy(imgs[i]), torch.from_numpy(cond), st, True)
        loss = loss + (s * torch.from_numpy(ws[i])).sum() + (lat * torch.from_numpy(wl[i])).sum()
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lat.detach().numpy(), np.asarray(l_ref), rtol=1e-4,
                                   atol=1e-5)
        assert_stats_close(st, flat_stats(st_ref), f"forward {i}")
    loss.backward()
    assert_trees_close(param_grads(d), grads, 1e-4, "discriminator grads")


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_aux_reg_neutron_matches_jax(norm):
    """Train on JAX's keep masks (and, under ``batch``, the routing mask):
    outputs, new statistics, parameter gradients; then the eval form (the
    running statistics, no dropout)."""
    img = images(10)
    ja = JaxAuxRegNeutron(norm=norm)
    params, stats = random_trees(ja, (jnp.asarray(img),), 11)
    masked = norm == "batch"
    extra = (jnp.asarray(MASK),) if masked else ()
    rngs = {"dropout": jax.random.PRNGKey(12)}
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _, inter = jax.jit(lambda: ja.apply(variables, jnp.asarray(img), True, *extra, rngs=rngs,
                                        capture_intermediates=is_dropout,
                                        mutable=["intermediates", "batch_stats"]))()
    keep = dropout_keep(inter)
    w = np.random.default_rng(13).standard_normal((B, 2)).astype(np.float32)

    def j_loss(p):
        out, upd = ja.apply({**variables, "params": p}, jnp.asarray(img), True, *extra,
                            rngs=rngs, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd.get("batch_stats", {}))

    grads, (out_ref, st_ref) = jax.jit(jax.grad(j_loss, has_aux=True))(params)
    a = AuxRegNeutron(norm=norm)
    a.load_state_dict(to_state_dict(params, stats or None))
    assert [tuple(k.shape[1:]) for k in keep] == list(a.dropout_shapes)
    y, new = a(torch.from_numpy(img), keep, True, torch.from_numpy(MASK) if masked else None)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out_ref), rtol=1e-4, atol=1e-5)
    assert_stats_close(new, flat_stats(st_ref), "aux stats")
    assert_trees_close(param_grads(a), grads, 1e-4, "aux grads")
    ref_eval = jax.jit(lambda: ja.apply(variables, jnp.asarray(img), False))()
    with torch.no_grad():
        np.testing.assert_allclose(a(torch.from_numpy(img)).numpy(), np.asarray(ref_eval),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the masked stacks, init_state
# ---------------------------------------------------------------------------

NEUTRON_BATCH = [*NEUTRON_OVERRIDES, "model.norm=batch", "model.n_experts=2",
                 "model.generator.width=0.125"]


def stacked_keep(module_cls, kwargs, in_axes, variables, args, key, e):
    """The keep masks ``[E, B, ...]`` of a stack of ``module_cls`` applied as
    ``stack_experts`` stacks it (the ``dropout`` rng split per expert),
    captured from a re-stacking that also collects ``intermediates``."""
    probe = nn.vmap(module_cls, in_axes=in_axes, out_axes=0,
                    variable_axes={"params": 0, "batch_stats": 0, "intermediates": 0},
                    split_rngs={"params": True, "dropout": True}, axis_size=e)(**kwargs)
    _, inter = jax.jit(lambda: probe.apply(variables, *args, rngs={"dropout": key},
                                           capture_intermediates=is_dropout,
                                           mutable=["intermediates", "batch_stats"]))()
    return dropout_keep(inter)


def test_masked_stacks_match_jax():
    """``model.norm=batch``: the port's per-expert training forwards with each
    expert's routing mask against JAX's ``generator_masked`` and
    ``aux_reg_masked`` (in_axes 0 over the masks): outputs and new
    statistics; the stacks' keep masks captured as :func:`stacked_keep`."""
    jcfg = jax_load_config(overrides=NEUTRON_BATCH)
    jm = jax_build_moe(jcfg)
    state = init_state_jit(jm, jcfg, jax.random.PRNGKey(14))
    pm = build_moe(load_config(NEUTRON_BATCH))
    assert pm.masked and pm.names["discriminator"] == "DiscriminatorNeutron"
    noise, cond = gen_inputs(15)
    masks = np.stack([MASK, 1 - MASK])
    key = jax.random.PRNGKey(16)
    gvars = {"params": state.gen.params, **state.gen.stats}
    gargs = (jnp.asarray(noise), jnp.asarray(cond), True, jnp.asarray(masks))
    fakes, gst = jax.jit(lambda: jm.generator_masked.apply(gvars, *gargs, rngs={"dropout": key},
                                                           mutable=["batch_stats"]))()
    keep = stacked_keep(JaxGeneratorNeutron, {"norm": "batch", "width": 0.125},
                        (None, None, None, 0), gvars, gargs, key, 2)
    avars = {"params": state.aux.params, **state.aux.stats}
    aargs = (fakes, True, jnp.asarray(masks))
    pred, ast = jax.jit(lambda: jm.aux_reg_masked.apply(avars, *aargs, rngs={"dropout": key},
                                                        mutable=["batch_stats"]))()
    akeep = stacked_keep(JaxAuxRegNeutron, {"norm": "batch"}, (0, None, 0), avars, aargs, key, 2)
    tm = torch.from_numpy(masks)
    port = lambda c: to_state_dict(c.params, stacked=True)  # noqa: E731
    outs = [pm.generate_train(p, s, torch.from_numpy(noise), torch.from_numpy(cond),
                              tuple(k[e] for k in keep), tm[e])
            for e, (p, s) in enumerate(zip(expert_slices(port(state.gen), 2),
                                           expert_slices(flat_stats(state.gen.stats
                                                                    ["batch_stats"]), 2)))]
    np.testing.assert_allclose(torch.stack([o for o, _ in outs]).detach().numpy(),
                               np.asarray(fakes), rtol=1e-4, atol=1e-5)
    assert_stats_close(stack_trees([s for _, s in outs]), flat_stats(gst["batch_stats"]),
                       "generator_masked stats")
    ours, new = pm.regress_all(port(state.aux), flat_stats(state.aux.stats["batch_stats"]),
                               torch.from_numpy(np.array(fakes)), akeep, tm)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(pred), rtol=1e-4, atol=1e-5)
    assert_stats_close(new, flat_stats(ast["batch_stats"]), "aux_reg_masked stats")


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_init_state_matches_jax_tree(norm):
    """The port's ``init_state`` has JAX's leaves and shapes, every
    component; BatchNorm starts at mean 0, var 1, stacked per expert."""
    ov = [*NEUTRON_OVERRIDES, f"model.norm={norm}", "model.n_experts=2",
          "model.generator.width=0.125"]
    jcfg = jax_load_config(overrides=ov)
    ref = train_state_to_jax(train_state_from_jax(
        init_state_jit(jax_build_moe(jcfg), jcfg, jax.random.PRNGKey(0)), "cpu"))
    cfg = load_config(ov)
    ours = train_state_to_jax(init_state(build_moe(cfg), cfg, seed=0, device="cpu"))

    def shapes(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: np.shape(tree)}
        return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{prefix}/{k}").items()}

    assert shapes(ours) == shapes(ref)
    for comp in ("gen", "aux"):
        bs = ours[comp]["stats"].get("batch_stats", {})
        assert bool(bs) == (norm == "batch")
        for name, s in bs.items():
            assert np.all(s["mean"] == 0) and np.all(s["var"] == 1), (comp, name)
            np.testing.assert_array_equal(s["mean"], ref[comp]["stats"]["batch_stats"][name]
                                          ["mean"])
