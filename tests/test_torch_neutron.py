"""The port's neutron generators against the JAX modules, on the CPU.

``GeneratorNeutron`` (``norm`` ``batch``, ``group``, ``none``; widths 1 and
0.125) and ``GeneratorNeutronV2`` (``group``, ``none``) on random trees
(the JAX initialisation with every leaf perturbed from a seed, and for
``batch`` perturbed running statistics as tests/test_neutron_fast.py:18-39)
against JAX's module ``apply`` in eval at 1e-4; the neutron teacher
artifact's experts; the weight round trip through ``zdcsim_torch.convert``
with ``batch_stats``; and the generator rule of ``build_moe``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from zdcsim.models.neutron import GeneratorNeutron as JaxNeutron
from zdcsim.models.neutron import GeneratorNeutronV2 as JaxNeutronV2
from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.convert import (
    expert, from_state_dict, stats_from_jax, stats_to_jax, to_state_dict, tree_to_torch,
)
from zdcsim_torch.models import generator_spec
from zdcsim_torch.models.layers import MaskedBatchNorm
from zdcsim_torch.models.neutron import GeneratorNeutron, GeneratorNeutronV2

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate")
TEACHER = os.path.join(ART, "neutron_teacher_serving_weights.npz")
B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 10)).astype(np.float32),
            rng.standard_normal((B, 9)).astype(np.float32))


def random_variables(module, seed):
    """``(params, batch_stats)`` numpy trees of ``module``: its Flax
    initialisation (LeCun-normal kernels) with the leaves that it sets to
    constants drawn from a seed (biases N(0, 0.1), norm scales 1 + N(0,
    0.1)) and 0.5 added to the output bias, and the running statistics drawn as
    tests/test_neutron_fast.py:27-38 draws them (mean N(0, 0.3), var
    0.5 + U(0, 1))."""
    noise, cond = inputs(seed)
    v = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                    noise, cond, False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) if path[-1].key == "kernel"
                         else np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                         ).astype(np.float32),
        v["params"])
    # a positive output bias, so that the final ReLU passes pixels to compare
    params["Conv_3"]["bias"] = params["Conv_3"]["bias"] + np.float32(0.5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.3 * rng.standard_normal(a.shape) if path[-1].key == "mean"
                         else 0.5 + rng.random(a.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    return params, stats


def port_forward(module, params, stats, noise, cond):
    module.load_state_dict(to_state_dict(params, stats))  # strict: every name and shape maps
    with torch.no_grad():
        return module.eval()(torch.from_numpy(noise), torch.from_numpy(cond)).numpy()


def jax_forward(module, params, stats, noise, cond):
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    return np.asarray(module.apply(variables, noise, cond, False))


@pytest.mark.parametrize("width", [1.0, 0.125])
@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_generator_neutron_matches_jax_module(norm, width):
    jmod = JaxNeutron(norm=norm, width=width)
    params, stats = random_variables(jmod, 3)
    assert bool(stats) == (norm == "batch")
    noise, cond = inputs(4)
    ref = jax_forward(jmod, params, stats, noise, cond)
    out = port_forward(GeneratorNeutron(norm=norm, width=width), params, stats, noise, cond)
    assert out.shape == ref.shape == (B, 44, 44, 1)
    assert (ref > 0).mean() > 0.02  # the ReLU leaves pixels to compare
    # tolerance of tests/test_neutron_fast.py:52
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", [1.0, 0.125])
@pytest.mark.parametrize("norm", ["group", "none"])
def test_generator_neutron_v2_matches_jax_module(norm, width):
    jmod = JaxNeutronV2(norm=norm, width=width)
    params, _ = random_variables(jmod, 5)
    noise, cond = inputs(6)
    ref = jax_forward(jmod, params, {}, noise, cond)
    out = port_forward(GeneratorNeutronV2(norm=norm, width=width), params, {}, noise, cond)
    assert out.shape == ref.shape == (B, 44, 44, 1)
    assert (ref > 0).mean() > 0.02
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_v2_refuses_batch_norm_as_jax():
    with pytest.raises(ValueError, match="GeneratorNeutron"):
        GeneratorNeutronV2(norm="batch")
    with pytest.raises(ValueError, match="norm"):
        GeneratorNeutron(norm="layer")


def test_training_forward_is_not_ported():
    noise, cond = (torch.from_numpy(a) for a in inputs(0))
    for module in (GeneratorNeutron(), GeneratorNeutronV2(width=0.125)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            module(noise, cond, train=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        MaskedBatchNorm(3)(torch.zeros(2, 3), train=True)


@pytest.fixture(scope="module")
def teacher():
    gp, gs, rp, meta = jax_load(TEACHER)
    assert (meta["family"], meta["norm"], gs) == ("neutron", "group", {})
    return gp


@pytest.mark.parametrize("e", [0, 1, 2])
def test_teacher_expert_forward_matches_jax_module(teacher, e):
    """The neutron teacher artifact (``norm="group"``, full width): each
    expert's module forward against JAX's."""
    pe = jax.tree_util.tree_map(lambda a: a[e], teacher)
    noise, cond = inputs(20 + e)
    ref = jax_forward(JaxNeutron(norm="group"), pe, {}, noise, cond)
    out = port_forward(GeneratorNeutron(norm="group"), pe, {}, noise, cond)
    assert out.shape == ref.shape == (B, 44, 44, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y), path


def test_batch_stats_round_trip_is_lossless():
    """Params and ``batch_stats`` of a stacked ``norm="batch"`` tree through
    ``stats_from_jax``/``to_state_dict``, a module's ``state_dict`` and back:
    bit-equal, every BatchNorm leaf mapped both ways."""
    params, stats = random_variables(JaxNeutron(norm="batch", width=0.125), 8)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), params, params)
    stacked_stats = jax.tree_util.tree_map(lambda *a: np.stack(a), stats, stats)
    gen_stats = {"batch_stats": stacked_stats}
    torch_stats = stats_from_jax(gen_stats)
    assert set(torch_stats) == {f"MaskedBatchNorm_{i}" for i in range(5)}
    _assert_trees_equal(stats_to_jax(torch_stats), gen_stats)

    module = GeneratorNeutron(norm="batch", width=0.125)
    sd = to_state_dict(expert(tree_to_torch(stacked), 1), expert(torch_stats, 1))
    assert sd["MaskedBatchNorm_2.running_var"].shape == (32,)
    module.load_state_dict(sd)
    back_stats = {}
    back = from_state_dict(module.state_dict(), stats_out=back_stats)
    _assert_trees_equal(back, params)
    _assert_trees_equal(back_stats, stats)
    with pytest.raises(ValueError, match="stats_out"):
        from_state_dict(module.state_dict())
    assert stats_from_jax(None) == {} and stats_to_jax({}) == {}
    with pytest.raises(ValueError, match="collections"):
        stats_from_jax({"spectral": {}})


def test_generator_spec_is_build_moes_rule():
    """``generator_spec`` picks the class ``build_moe`` picks, with its
    keyword arguments, and refuses a version the architecture lacks."""
    from zdcsim.config import load_config as jax_config
    from zdcsim.models import build_moe

    for overrides in ([], ["model.generator.width=0.125"],
                      ["model.architecture=neutron", "model.norm=none",
                       "model.generator.width=0.25"],
                      ["model.architecture=neutron", "model.norm=group",
                       "model.generator.version=v2"]):
        ref = build_moe(jax_config(overrides=overrides))
        m = jax_config(overrides=overrides).model
        cls, kwargs = generator_spec(m.architecture, m.generator.version, m.norm,
                                     m.generator.width)
        assert cls.__name__ == ref.names["generator"], overrides
        single = ref.generator_single
        assert kwargs["width"] == single.width
        if m.architecture == "neutron":
            assert kwargs["norm"] == single.norm
        else:
            assert "norm" not in kwargs
    with pytest.raises(ValueError, match="no generator version"):
        generator_spec("proton", "v2")
