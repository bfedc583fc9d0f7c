"""The port's neutron serving forward against the JAX package, on the CPU
(mirror of tests/test_neutron_fast.py).

The BatchNorm fold against JAX's fold and against the module eval forward
(1e-4); ``is_foldable``/``is_prefolded`` on the three neutron artifacts and
a ``norm="batch"`` tree; ``fast_neutron_apply`` in f32 on both distilled
students against JAX's (1e-5 of the largest pixel; tests/test_neutron_fast.py:136
holds JAX against JAX at 1e-5); on int8
against JAX's int8 (the quantised operands of the first site equal, the
output within the int8 bound of tests/test_pallas_decode.py:203) and
against f32 (per-shower log1p sums within rtol 0.1,
tests/test_neutron_fast.py:64); the ``amax_out`` capture against JAX's; and
static scales equal to dynamic ones bit for bit at the captured maxima.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.models import neutron_fast as jnf
from zdcsim.models.neutron import GeneratorNeutron as JaxNeutron
from zdcsim.models.proton_fast import _quant_act as jax_quant_act
from zdcsim.models.proton_fast import _quant_per_cout as jax_quant_per_cout
from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.convert import to_state_dict, tree_to_torch
from zdcsim_torch.models import neutron_fast as nf
from zdcsim_torch.models.neutron import GeneratorNeutron
from zdcsim_torch.models.proton_fast import _quant_act

from test_torch_neutron import inputs, random_variables

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate")
ARTIFACTS = {
    "teacher": "neutron_teacher_serving_weights.npz",
    "w0.125": "neutron_student_w0.125_serving_weights.npz",
    "w0.25": "neutron_student_w0.25_serving_weights.npz",
}
SITES = {"conv0", "conv1", "conv2"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[1.0, 0.125])
def batch_tree(request):
    """A ``norm="batch"`` tree with drawn running statistics (numpy)."""
    width = request.param
    params, stats = random_variables(JaxNeutron(norm="batch", width=width), 11)
    return params, stats, width


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_fold_matches_jax_fold_and_module_eval(batch_tree):
    params, stats, width = batch_tree
    ref_fold = jnf.fold_neutron_params(params, stats)
    folded = nf.fold_neutron_params(tree_to_torch(params), tree_to_torch(stats))
    assert set(folded) == set(ref_fold) == {"Dense_0", "Dense_1", "Conv_0", "Conv_1", "Conv_2",
                                            "Conv_3"}
    for (path, a), (_, b) in zip(_leaves(folded), _leaves(ref_fold)):
        assert a.dtype == torch.float32 and a.shape == b.shape, path
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=str(path))
    assert nf.is_prefolded(folded)

    noise, cond = inputs(12)
    module = GeneratorNeutron(norm="batch", width=width)
    module.load_state_dict(to_state_dict(params, stats))
    with torch.no_grad():
        eval_out = module.eval()(torch.from_numpy(noise), torch.from_numpy(cond)).numpy()
    out = nf.fast_neutron_apply(folded, torch.from_numpy(noise), torch.from_numpy(cond)).numpy()
    ref = np.asarray(JaxNeutron(norm="batch", width=width).apply(
        {"params": params, "batch_stats": stats}, noise, cond, False))
    assert out.shape == (4, 44, 44, 1)
    # tolerance of tests/test_neutron_fast.py:52
    np.testing.assert_allclose(out, eval_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_foldable_and_prefolded_as_jax_on_the_artifacts(name):
    gp, gs, _, meta = jax_load(os.path.join(ART, ARTIFACTS[name]))
    pe = tree_to_torch(jax.tree_util.tree_map(lambda a: a[0], gp))
    assert nf.is_foldable(pe) == jnf.is_foldable(gp) is False
    assert nf.is_prefolded(pe) == jnf.is_prefolded(pe) == (meta["norm"] == "none")
    assert gs == {}


def test_foldable_and_prefolded_on_a_batch_tree(batch_tree):
    params, _, _ = batch_tree
    assert nf.is_foldable(params) and jnf.is_foldable(params)
    assert not nf.is_prefolded(params) and not jnf.is_prefolded(params)


@pytest.fixture(scope="module", params=["w0.125", "w0.25"])
def student(request):
    gp, _, _, meta = jax_load(os.path.join(ART, ARTIFACTS[request.param]))
    assert meta["norm"] == "none"
    return gp


@pytest.mark.parametrize("e", [0, 1, 2])
def test_fast_apply_f32_matches_jax_on_the_students(student, e):
    pe = jax.tree_util.tree_map(lambda a: a[e], student)
    noise, cond = inputs(30 + e)
    ref = np.asarray(jnf.fast_neutron_apply(pe, noise, cond))
    out = nf.fast_neutron_apply(tree_to_torch(pe), torch.from_numpy(noise),
                                torch.from_numpy(cond)).numpy()
    assert out.shape == ref.shape == (4, 44, 44, 1) and out.dtype == np.float32
    # 1e-5 (tests/test_neutron_fast.py:136, JAX against JAX) relative to the
    # output's largest pixel: on these trained trees both packages' float32
    # lies up to 1.1e-5 from a float64 forward at pixels up to 8.3, so an
    # absolute 1e-5 is below what either side's rounding can hold
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _int8_bound(ref):
    """Bound of tests/test_pallas_decode.py:203 for int8 paths, where a
    rounding flip of one activation cascades through the later convs."""
    return 0.05 * float(np.abs(ref).max()) + 0.05


@pytest.mark.parametrize("e", [0, 2])
def test_fast_apply_int8_matches_jax_int8_and_f32(student, e):
    pe = jax.tree_util.tree_map(lambda a: a[e], student)
    pt = tree_to_torch(pe)
    noise, cond = inputs(40 + e)
    z, c = torch.from_numpy(noise), torch.from_numpy(cond)
    ref = np.asarray(jnf.fast_neutron_apply(pe, noise, cond, int8=True))
    out = nf.fast_neutron_apply(pt, z, c, int8=True).numpy()
    assert out.shape == ref.shape == (4, 44, 44, 1)
    assert np.isfinite(out).all() and out.min() >= 0.0
    err = np.abs(out - ref).max()
    print(f"int8 fast_neutron_apply max |port - jax| = {err}")
    assert err < _int8_bound(ref)

    # the first site's quantised operands equal JAX's: the Dense layers agree
    # to the last bits, so the activation and its per-tensor scale do
    x = torch.cat([z, c], 1)
    for name in ("Dense_0", "Dense_1"):
        x = torch.nn.functional.leaky_relu(x @ pt[name]["kernel"] + pt[name]["bias"], 0.1)
    xq, _ = _quant_act(x)
    xj = jnp.concatenate([noise, cond], 1)
    for name in ("Dense_0", "Dense_1"):
        xj = jax.nn.leaky_relu(xj @ pe[name]["kernel"] + pe[name]["bias"], 0.1)
    xqj, _ = jax_quant_act(xj)
    assert np.array_equal(xq.numpy(), np.asarray(xqj))
    kq, sk = nf.quantize_neutron_weights(pt)["Conv_0"]
    kqj, skj = jax_quant_per_cout(pe["Conv_0"]["kernel"])
    assert np.array_equal(kq.numpy(), np.asarray(kqj)) and np.array_equal(sk.numpy(),
                                                                          np.asarray(skj))

    # against f32: per-shower log1p sums (tests/test_neutron_fast.py:64)
    f32 = nf.fast_neutron_apply(pt, z, c).numpy()
    np.testing.assert_allclose(np.log1p(f32.sum((1, 2, 3))), np.log1p(out.sum((1, 2, 3))),
                               rtol=0.1)


def test_int8_on_a_batch_tree_is_close_to_f32(batch_tree):
    """tests/test_neutron_fast.py:57-67 in the port: the folded full-width
    (Conv_0 128 -> 256, Conv_1 256 -> 128, Conv_2 128 -> 64) and narrow
    trees on int8 against f32."""
    params, stats, _ = batch_tree
    folded = nf.fold_neutron_params(tree_to_torch(params), tree_to_torch(stats))
    noise, cond = (torch.from_numpy(a) for a in inputs(13))
    a = nf.fast_neutron_apply(folded, noise, cond).numpy()
    b = nf.fast_neutron_apply(folded, noise, cond, int8=True).numpy()
    assert b.shape == a.shape and np.isfinite(b).all() and b.min() >= 0.0
    np.testing.assert_allclose(np.log1p(a.sum((1, 2, 3))), np.log1p(b.sum((1, 2, 3))), rtol=0.1)


def test_amax_matches_jax(student):
    """The captured maxima against JAX's on the same numpy inputs (f32,
    int8), within 2e-3 relative (the bound of
    tests/test_torch_static_quant.py::test_amax_matches_jax)."""
    pe = jax.tree_util.tree_map(lambda a: a[1], student)
    noise, cond = inputs(50)
    ref, out = {}, {}
    jnf.fast_neutron_apply(pe, noise, cond, int8=True, amax_out=ref)
    nf.fast_neutron_apply(tree_to_torch(pe), torch.from_numpy(noise), torch.from_numpy(cond),
                          int8=True, amax_out=out)
    assert set(out) == set(ref) == SITES
    for k in SITES:
        assert out[k].dtype == torch.float32 and out[k].ndim == 0
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=2e-3, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_equals_dynamic_at_captured_scales(student, dtype):
    pt = tree_to_torch(jax.tree_util.tree_map(lambda a: a[0], student), dtype=dtype)
    z, c = (torch.from_numpy(a).to(dtype) for a in inputs(51))
    amax = {}
    dyn = nf.fast_neutron_apply(pt, z, c, int8=True, amax_out=amax)
    assert set(amax) == SITES
    scales = {k: torch.clamp(v / 127.0, min=1e-12) for k, v in amax.items()}
    stat = nf.fast_neutron_apply(pt, z, c, int8=True, act_scales=scales)
    assert dyn.dtype == dtype and torch.equal(dyn, stat)
