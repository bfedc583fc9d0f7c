"""The port's ``FastSim`` on the neutron family against the JAX engine, on
the CPU.

The three neutron artifacts (the group-norm teacher on its module, the
``norm="none"`` students on ``fast_neutron_apply``) and a folded full-width
``norm="batch"`` tree with its ``gen_stats``, on ``f32``, ``bf16`` and
``int8`` through ``simulate_switch`` on the JAX engine's own noise; the
teacher's ``int8`` equal to its ``bf16`` module, as in JAX; the dyn tile
loop equal to the switch path (``torch.equal``), the dense ``simulate``,
``simulate_grouped`` and ``simulate_stream`` against JAX's on its noise;
static activation quant; and the four kernel precisions refused.

The students' own routers send most N(0, 1) conditions to one expert, so
the forms that must read every expert serve behind a router drawn from a
seed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config
from zdcsim_torch.inference.engine import FastSim

from test_torch_engine_api import grouped_noise, jax_noise, seeded_router
from test_torch_neutron import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "gate")
ARTIFACTS = {
    "teacher": "neutron_teacher_serving_weights.npz",
    "w0.125": "neutron_student_w0.125_serving_weights.npz",
    "w0.25": "neutron_student_w0.25_serving_weights.npz",
}
KERNEL_PRECISIONS = ("int8_pallas_ab", "int8_pallas", "int8_fused_front", "int8_fused")
B = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def model_overrides(meta):
    out = [f"model.norm={meta.get('norm', 'batch')}"]
    if "width" in meta:
        out.append(f"model.generator.width={float(meta['width'])}")
    return out


@pytest.fixture(scope="module", params=sorted(ARTIFACTS))
def artifact(request):
    gp, gs, rp, meta = jax_load(os.path.join(ART, ARTIFACTS[request.param]))
    return request.param, gp, gs, rp, model_overrides(meta)


@pytest.fixture(scope="module")
def batch_tree():
    """A full-width ``norm="batch"`` tree of 3 experts (numpy) with drawn
    running statistics, as ``gen_stats``."""
    from zdcsim.models.neutron import GeneratorNeutron as JaxNeutron

    trees = [random_variables(JaxNeutron(norm="batch"), 60 + e) for e in range(3)]
    stack = lambda *a: np.stack(a)  # noqa: E731
    gp = jax.tree_util.tree_map(stack, *[p for p, _ in trees])
    stats = jax.tree_util.tree_map(stack, *[s for _, s in trees])
    return gp, {"batch_stats": stats}, ["model.norm=batch"]


def port(gp, gs, router, overrides, precision, batch_size=B, **kw):
    cfg = load_config([*NEUTRON_OVERRIDES, *overrides])
    return FastSim(gp, router, batch_size=batch_size, precision=precision, device="cpu",
                   cfg=cfg, gen_stats=gs, **kw)


def jax_engine(gp, gs, router, overrides, precision, batch_size=B):
    from zdcsim.config import load_config as jax_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe

    cfg = jax_config(os.path.join(REPO, "zdcsim", "config", "neutron.yaml"),
                     overrides=["model.n_experts=3", *overrides])
    return JaxFastSim(build_moe(cfg), gp, gs, router, batch_size=batch_size, precision=precision)


def conditions(seed, n=B):
    return np.random.default_rng(seed).standard_normal((n, 9)).astype(np.float32)


def assert_close(out, ref, precision, int8_convs=False):
    """f32: log space within 1e-4 (the module tolerance,
    tests/test_neutron_fast.py:52); bf16: the log1p bound of
    tests/test_pallas_decode.py:203 (a rounding flip cascades); int8 convs
    (``int8_convs``): per-shower log1p sums within rtol 0.1, JAX's own rule
    for int8 against float (tests/test_neutron_fast.py:64). The bf16 Dense
    outputs of the two packages differ in the last bit in about 15% of the
    elements (their sums run in other orders), which flips a few int8
    activations, and with no norm between the students' convs a flip
    cascades to pixels; tests/test_torch_neutron_fast.py holds the int8
    forward pixel by pixel in float32, where the operands agree."""
    out, ref = np.asarray(out), np.asarray(ref)
    log_out, log_ref = np.log1p(out), np.log1p(ref)
    assert log_out.shape == log_ref.shape and np.isfinite(log_out).all()
    err = np.abs(log_out - log_ref).max()
    sums_out, sums_ref = np.log1p(out.sum((1, 2))), np.log1p(ref.sum((1, 2)))
    rel = float((np.abs(sums_out - sums_ref) / np.abs(sums_ref)).max())
    print(f"{precision}: max |log1p port - log1p jax| = {err}; per-shower log1p sums rel {rel}")
    if precision == "f32":
        np.testing.assert_allclose(log_out, log_ref, rtol=1e-4, atol=1e-4)
    elif int8_convs:
        np.testing.assert_allclose(sums_out, sums_ref, rtol=0.1)
    else:
        assert err < 0.05 * float(np.abs(log_ref).max()) + 0.05


def switch_against_jax(gp, gs, rp, overrides, precision, cond):
    key = jax.random.PRNGKey(5)
    jeng = jax_engine(gp, gs, rp, overrides, precision, len(cond))
    jeng._build_switch(tile=4)
    ref, ref_ids = (np.asarray(a) for a in jeng.simulate_switch(cond, key, return_experts=True))
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = jax_noise(jax.random.fold_in(key, 0), len(cond), dtype)
    eng = port(gp, gs, rp, overrides, precision, len(cond))
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert out.shape == ref.shape == (len(cond), 44, 44) and out.dtype == torch.float32
    assert out.min() >= 0
    assert_close(out, ref, precision, eng._int8)
    return eng, jeng, out, noise


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_fastsim_serves_the_artifacts_as_jax(artifact, precision):
    name, gp, gs, rp, overrides = artifact
    eng, jeng, out, noise = switch_against_jax(gp, gs, rp, overrides, precision, conditions(3))
    assert eng.fast_neutron == jeng._fast_neutron == (name != "teacher")
    assert eng.uses_fast_path is jeng.uses_fast_path is False
    assert eng._int8 == jeng._int8 == (precision == "int8" and name != "teacher")
    if name == "teacher" and precision == "int8":
        # JAX serves the group-norm teacher's bf16 module on int8: so does the port
        bf16 = port(gp, gs, rp, overrides, "bf16", B)
        bf16._build_switch(tile=4)
        assert torch.equal(out, bf16.simulate_switch(conditions(3), noise=noise))


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_fastsim_folds_a_batch_tree_as_jax(batch_tree, precision):
    """A full-width ``norm="batch"`` tree with ``gen_stats``: folded once at
    build, served on ``fast_neutron_apply`` (int8 on the 128 -> 256,
    256 -> 128 and 128 -> 64 convs), behind a seeded router."""
    gp, gs, overrides = batch_tree
    eng, jeng, _, _ = switch_against_jax(gp, gs, seeded_router(41), overrides, precision,
                                         conditions(4, 4))
    assert eng.fast_neutron and jeng._fast_neutron and set(eng._experts[0]) == {
        "Dense_0", "Dense_1", "Conv_0", "Conv_1", "Conv_2", "Conv_3"}


def test_a_batch_tree_without_its_statistics_is_refused(batch_tree):
    gp, _, overrides = batch_tree
    with pytest.raises(ValueError, match="gen_stats"):
        port(gp, None, seeded_router(41), overrides, "f32")


@pytest.mark.parametrize("precision", KERNEL_PRECISIONS)
def test_kernel_precisions_refuse_the_neutron_family(artifact, precision):
    """JAX documents the kernel precisions as proton only and runs its XLA
    int8 on a neutron tree; the port refuses them, so that no path reports
    kernels it does not launch."""
    _, gp, gs, rp, overrides = artifact
    with pytest.raises(ValueError, match="proton only"):
        port(gp, gs, rp, overrides, precision)


@pytest.fixture(scope="module")
def student():
    gp, gs, _, meta = jax_load(os.path.join(ART, ARTIFACTS["w0.125"]))
    return gp, gs, model_overrides(meta)


@pytest.fixture(scope="module")
def teacher():
    gp, gs, _, meta = jax_load(os.path.join(ART, ARTIFACTS["teacher"]))
    return gp, gs, model_overrides(meta)


@pytest.mark.parametrize("which,precision", [("student", "int8"), ("student", "f32"),
                                             ("teacher", "bf16")])
def test_dyn_dispatch_equals_switch(student, teacher, which, precision):
    """The dyn tile loop (weights gathered by the tile's expert; the module
    path through ``functional_call`` on the stacked state) equals the
    per-expert path bit for bit; ``simulate_bulk`` is that loop on the CPU."""
    gp, gs, overrides = student if which == "student" else teacher
    router = seeded_router(40)
    cond = conditions(8, 2 * B)
    noise = np.random.default_rng(9).standard_normal((2 * B, 10)).astype(np.float32)
    eng = port(gp, gs, router, overrides, precision)
    eng._build_switch(tile=4)
    a, ia = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert np.bincount(ia.numpy(), minlength=3).min() > 0
    eng._build_switch(tile=4, dyn_dispatch=True)
    b, ib = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert torch.equal(a, b) and torch.equal(ia, ib)
    assert torch.equal(eng.simulate_bulk(cond, noise=noise), a)


@pytest.mark.parametrize("which,precision", [("student", "int8"), ("teacher", "f32")])
def test_dense_simulate_matches_jax(student, teacher, which, precision):
    gp, gs, overrides = student if which == "student" else teacher
    router = seeded_router(40)
    cond = conditions(10)
    key = jax.random.PRNGKey(4)
    ref, ref_ids = jax_engine(gp, gs, router, overrides, precision).simulate(
        cond, key, return_experts=True)
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = jax_noise(jax.random.fold_in(key, 0), B, dtype)
    eng = port(gp, gs, router, overrides, precision)
    out, ids = eng.simulate(cond, noise=noise, return_experts=True)
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids)) and len(set(ids.tolist())) == 3
    assert_close(out, ref, precision, eng._int8)


@pytest.mark.parametrize("which,precision", [("student", "int8"), ("teacher", "bf16")])
@pytest.mark.parametrize("mode", ["grouped", "stream"])
def test_grouped_and_stream_match_jax(student, teacher, which, precision, mode):
    """Host-side buckets, on JAX's per-bucket noise: the student on
    ``fast_neutron_apply`` (as JAX's ``decode_one`` on a folded tree), the
    teacher on its module; the stream at batch 4, so an expert's samples
    span two chunks."""
    gp, gs, overrides = student if which == "student" else teacher
    router = seeded_router(40)
    cond = conditions(10)
    key = jax.random.PRNGKey(6)
    batch = 4 if mode == "stream" else B
    jeng = jax_engine(gp, gs, router, overrides, precision, batch)
    ref = np.asarray(getattr(jeng, f"simulate_{mode}")(cond, key))
    eng = port(gp, gs, router, overrides, precision, batch)
    idx = eng._route(torch.from_numpy(cond)).numpy()
    assert np.array_equal(idx, np.asarray(jeng._route(jeng._weights, cond)))
    if mode == "stream":
        assert np.bincount(idx, minlength=3).max() > batch
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = grouped_noise(key, idx, dtype, batch if mode == "stream" else None)
    out, ids = getattr(eng, f"simulate_{mode}")(cond, noise=noise, return_experts=True)
    assert out.shape == (B, 44, 44) and np.array_equal(ids.numpy(), idx)
    assert_close(out, ref, precision, eng._int8)


class SmallCalFastSim(FastSim):
    """A 64-row calibration (and a 256-row validation): the CPU's time."""

    CAL_BATCH = 64


def test_static_act_quant_on_the_student(student):
    """Static scales calibrated per expert with ``fast_neutron_apply``: the
    three sites of every expert, the headroom reported, the serve at the
    captured scales equal to the dynamic one's output where the scales are
    the dynamic ones, within rel 0.15 of the dynamic serve, and the dyn
    tile loop equal to the switch path."""
    gp, gs, overrides = student
    router = seeded_router(40)
    cfg = load_config([*NEUTRON_OVERRIDES, *overrides])
    eng = SmallCalFastSim(gp, router, batch_size=B, precision="int8", device="cpu", cfg=cfg,
                          static_act_quant=True)
    assert len(eng._act_scales) == 3 and eng.act_scale_headroom is not None
    print(f"act_scale_headroom {eng.act_scale_headroom}")
    assert eng.act_scale_headroom > 0
    for sc in eng._act_scales:
        assert set(sc) == {"conv0", "conv1", "conv2"}
        assert all(v.dtype == torch.float32 and v.ndim == 0 and v > 0 for v in sc.values())
    cond = conditions(11)
    noise = np.random.default_rng(12).standard_normal((B, 10)).astype(np.float32)
    eng._build_switch(tile=4)
    stat = eng.simulate_switch(cond, noise=noise)
    eng._build_switch(tile=4, dyn_dispatch=True)
    assert torch.equal(eng.simulate_switch(cond, noise=noise), stat)
    dyn = port(gp, gs, router, overrides, "int8")
    dyn._build_switch(tile=4)
    ref = dyn.simulate_switch(cond, noise=noise)
    a, b = np.log1p(stat.sum((1, 2)).numpy()), np.log1p(ref.sum((1, 2)).numpy())
    assert np.abs(a - b).max() / np.abs(b).max() < 0.15

    # at scales equal to the ones a call takes dynamically, static equals dynamic
    from zdcsim_torch.models.neutron_fast import fast_neutron_apply

    p, q, _ = eng._expert_args(1)
    z = torch.from_numpy(noise).bfloat16()
    c = torch.from_numpy(cond).bfloat16()
    amax = {}
    dyn_out = fast_neutron_apply(p, z, c, int8=True, qweights=q, amax_out=amax)
    scales = {k: torch.clamp(v / 127.0, min=1e-12) for k, v in amax.items()}
    assert torch.equal(fast_neutron_apply(p, z, c, int8=True, qweights=q, act_scales=scales),
                       dyn_out)


def test_static_act_quant_on_the_teacher_module_is_ignored_as_jax(teacher):
    """JAX calibrates only a fast path: the teacher's module serves on int8
    without scales."""
    gp, gs, overrides = teacher
    eng = port(gp, gs, seeded_router(40), overrides, "int8", static_act_quant=True)
    assert eng._act_scales is None and eng.act_scale_headroom is None and not eng._int8
