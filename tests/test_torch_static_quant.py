"""Static calibrated int8 activation scales in the port (mirror of
tests/test_static_quant.py, the proton half).

``fast_generator_apply(act_scales=...)`` quantises each XLA-backend site with
a given f32 scale instead of one max per call, and ``amax_out`` captures the
maxima a calibration scales from. At the captured scales static equals
dynamic bit for bit (same division, rounding and clip). The captured maxima
equal JAX's on the same numpy inputs. ``FastSim(static_act_quant=True)``
calibrates each expert of the w=0.125 student and serves within rel 0.15 of
the dynamic ``int8`` serve; the kernel precisions refuse it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from zdcsim.models.proton import Generator as JaxGenerator
from zdcsim.models.proton_fast import fast_generator_apply as jax_apply
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import tree_to_torch
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.models.proton_fast import _quant_act, fast_generator_apply
from zdcsim_torch.utils.artifact import load_serving_artifact

STUDENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                       "student_w0.125_serving_weights.npz")
B = 8
SITES = {"conv0", "conv1", "conv2"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """A width-0.25 proton tree from the JAX module's initialisation (numpy),
    with seeded noise and conditions."""
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((B, 10)).astype(np.float32)
    cond = rng.standard_normal((B, 9)).astype(np.float32)
    p = JaxGenerator(width=0.25).init({"params": jax.random.PRNGKey(7)}, noise, cond,
                                      False)["params"]
    return jax.tree_util.tree_map(np.array, p), noise, cond


def _scales_from_amax(amax):
    # the dynamic path's scale arithmetic, as tests/test_static_quant.py:26
    return {k: torch.clamp(v / 127.0, min=1e-12) for k, v in amax.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_equals_dynamic_at_captured_scales(params, dtype):
    p, noise, cond = params
    pt = tree_to_torch(p, dtype=dtype)
    z, c = torch.from_numpy(noise).to(dtype), torch.from_numpy(cond).to(dtype)
    amax = {}
    dyn = fast_generator_apply(pt, z, c, int8=True, amax_out=amax)
    assert set(amax) == SITES
    assert all(v.dtype == torch.float32 and v.ndim == 0 and v > 0 for v in amax.values())
    stat = fast_generator_apply(pt, z, c, int8=True, act_scales=_scales_from_amax(amax))
    assert torch.equal(dyn, stat)


def test_amax_matches_jax(params):
    """The captured maxima of each site against JAX's on the same numpy
    inputs (f32), within 2e-3 relative: the sites after Conv_0 see int8
    activations whose rounding may flip where the two float paths differ in
    the last bit."""
    p, noise, cond = params
    ref = {}
    jax_apply(p, noise, cond, int8=True, amax_out=ref)
    out = {}
    fast_generator_apply(tree_to_torch(p), torch.from_numpy(noise), torch.from_numpy(cond),
                         int8=True, amax_out=out)
    assert set(out) == set(ref) == SITES
    for k in SITES:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=2e-3, err_msg=k)


def test_float_path_captures_every_site(params):
    """As JAX's ``_site``, the capture works in any precision mode."""
    p, noise, cond = params
    amax = {}
    fast_generator_apply(tree_to_torch(p), torch.from_numpy(noise), torch.from_numpy(cond),
                         amax_out=amax)
    assert set(amax) == SITES


@pytest.mark.parametrize("backend,sites", [("pallas_ab", {"conv1", "conv2"}),
                                           ("pallas", {"conv2"})])
def test_kernel_backends_capture_their_plain_sites_only(params, backend, sites):
    """The kernels quantise per sample inside and have no site; the stages
    they leave to plain PyTorch keep theirs (as JAX's branches)."""
    p, noise, cond = params
    amax = {}
    fast_generator_apply(tree_to_torch(p, dtype=torch.bfloat16),
                         torch.from_numpy(noise).bfloat16(), torch.from_numpy(cond).bfloat16(),
                         int8=True, int8_backend=backend, amax_out=amax)
    assert set(amax) == sites


def test_static_scale_clips_at_127():
    x = torch.tensor([[-3.0, -1.0, 0.0, 0.5, 2.0]])
    q, s = _quant_act(x, torch.tensor(1.0 / 127.0))
    assert torch.equal(q, torch.tensor([[-127, -127, 0, 64, 127]], dtype=torch.int8))
    assert s.dtype == torch.float32 and float(s) == np.float32(1.0 / 127.0)
    q_dyn, s_dyn = _quant_act(x)
    q_st, s_st = _quant_act(x, torch.clamp(x.abs().amax() / 127.0, min=1e-12))
    assert torch.equal(q_dyn, q_st) and torch.equal(s_dyn, s_st)


@pytest.fixture(scope="module")
def student():
    gp, _, rp, meta = load_serving_artifact(STUDENT)
    return gp, rp, load_config([f"model.generator.width={float(meta['width'])}"])


class SmallCalFastSim(FastSim):
    """FastSim calibrating on 64 + 256 rows an expert: the CPU decodes about
    a thousand rows a second, and the calibration's code is the same at
    any batch."""

    CAL_BATCH = 64


def test_calibration_constants_are_jax_s():
    from zdcsim.inference import FastSim as JaxFastSim

    assert (FastSim.CAL_BATCH, FastSim.ACT_SCALE_MARGIN) == (
        JaxFastSim.CAL_BATCH, JaxFastSim.ACT_SCALE_MARGIN) == (1024, 1.25)


@pytest.fixture(scope="module")
def static_engine(student):
    """One calibration for the module's tests."""
    gp, rp, cfg = student
    return SmallCalFastSim(gp, rp, batch_size=16, precision="int8", device="cpu", cfg=cfg,
                           static_act_quant=True)


def test_calibration_follows_its_formula(student, static_engine):
    """Scales ``max(amax * margin, 1e-12) / 127`` from each expert's maxima on
    the calibration batch (CPU generator seeded 0: noise, then conditions);
    the headroom the least margined maximum over the validation batch's
    (seeded 1, four times the rows)."""
    gp, rp, cfg = student
    eng = static_engine

    def amax(n, seed):
        gen = torch.Generator().manual_seed(seed)
        z = torch.randn((n, 10), generator=gen).bfloat16()
        c = torch.randn((n, 9), generator=gen).bfloat16()
        out = []
        for p, q in zip(eng._experts, eng._qweights):
            d = {}
            fast_generator_apply(p, z, c, int8=True, qweights=q, amax_out=d)
            out.append(d)
        return out

    cal, val = amax(64, 0), amax(256, 1)
    for sc, a in zip(eng._act_scales, cal):
        for k in SITES:
            assert torch.equal(sc[k], torch.clamp(a[k] * 1.25, min=1e-12) / 127.0)
    head = min(float(a[k] * 1.25 / v[k]) for a, v in zip(cal, val) for k in SITES)
    assert eng.act_scale_headroom == pytest.approx(head, rel=1e-6)


def test_engine_calibrates_a_scale_per_site_and_expert(static_engine):
    eng = static_engine
    assert len(eng._act_scales) == eng.n_experts == 3
    for sc in eng._act_scales:
        assert set(sc) == SITES
        assert all(v.dtype == torch.float32 and v.ndim == 0 and 0 < v < float("inf")
                   for v in sc.values())
    assert 0 < eng.act_scale_headroom < float("inf")
    eng._build_switch(tile=8, dyn_dispatch=True)
    stacked = eng._stacked[2]  # the dyn decoder gathers the scales as it gathers weights
    assert set(stacked) == SITES and all(v.shape == (3,) for v in stacked.values())
    eng._build_switch()


def test_engine_static_close_to_dynamic(student, static_engine):
    """Scales differ (calibration batch and margin against the max of each
    call), so closeness, not equality, as tests/test_static_quant.py:66."""
    gp, rp, cfg = student
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((16, 9)).astype(np.float32)
    noise = rng.standard_normal((16, 10)).astype(np.float32)
    dyn = FastSim(gp, rp, batch_size=16, precision="int8", device="cpu", cfg=cfg)
    a = dyn.simulate_switch(cond, noise=noise)
    b = static_engine.simulate_switch(cond, noise=noise)
    rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(a).clamp(min=1e-6))
    assert rel < 0.15, rel


def test_engine_static_dyn_dispatch_equals_static_switch(static_engine):
    """static_act_quant x dyn_dispatch (the JAX engine's ``engine.py:385``,
    which JAX never tested): the gathered per-expert scales decode as the
    switch path's, bit for bit."""
    eng = static_engine
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((16, 9)).astype(np.float32)
    noise = rng.standard_normal((16, 10)).astype(np.float32)
    eng._build_switch(tile=8)
    a = eng.simulate_switch(cond, noise=noise)
    eng._build_switch(tile=8, dyn_dispatch=True)
    b = eng.simulate_switch(cond, noise=noise)
    eng._build_switch()
    assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["int8_pallas_ab", "int8_pallas", "int8_fused_front",
                                       "int8_fused"])
def test_static_act_quant_refused_on_kernel_precisions(student, precision):
    gp, rp, cfg = student
    with pytest.raises(ValueError, match="static_act_quant requires the XLA int8 backend"):
        FastSim(gp, rp, precision=precision, device="cpu", cfg=cfg, static_act_quant=True)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_static_act_quant_is_ignored_by_float_precisions(student, precision):
    gp, rp, cfg = student
    eng = FastSim(gp, rp, precision=precision, device="cpu", cfg=cfg, static_act_quant=True)
    assert eng._act_scales is None and eng.act_scale_headroom is None
