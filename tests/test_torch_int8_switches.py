"""``proton_fast``'s int8 serving switches in the port against the JAX
package's, on the CPU: ``DEQUANT_DTYPE``, ``INT8_CONV2``,
``INT8_CONV0_IMPL`` (with ``upsample2_conv4_int8_naive``) and
``INT8_CONV1_IMPL``.

Each setting is held against JAX's with the same setting: its stages on
equal inputs (at ``tests/test_torch_proton.py``'s stage tolerance, and
within bf16 rounding where the dequantise runs in bf16), and the whole XLA
int8 forward of a narrow random generator (width 1/16) at the port's int8
bound (``tests/test_torch_proton.py``: ``0.05 max|ref| + 0.05``). Across
settings, JAX's ``tests/test_proton_fast.py:269
test_int8_conv_impl_selectors`` is mirrored on the port at full width
(per-image log1p sums within rtol 0.1). The quantized weights record their
form: a decode never mixes forms, and an engine built before a switch
flips keeps its form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zdcsim.models.proton_fast as J
import zdcsim_torch.models.proton_fast as T
from zdcsim.models.proton import Generator as JaxGenerator
from zdcsim_torch.convert import tree_to_torch

B = 4
# (name, JAX's value, the port's value): every setting other than the default
SETTINGS = [
    ("INT8_CONV0_IMPL", "naive", "naive"),
    ("INT8_CONV1_IMPL", "phase", "phase"),
    ("INT8_CONV1_IMPL", "folded", "folded"),
    ("INT8_CONV2", False, False),
    ("DEQUANT_DTYPE", jnp.bfloat16, torch.bfloat16),
]
IDS = ["conv0_naive", "conv1_phase", "conv1_folded", "conv2_float", "dequant_bf16"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _defaults():
    """Every test starts from, and leaves, JAX's and the port's defaults."""
    names = ("DEQUANT_DTYPE", "INT8_CONV2", "INT8_CONV0_IMPL", "INT8_CONV1_IMPL")
    saved = [(m, n, getattr(m, n)) for m in (J, T) for n in names]
    assert [v for _, _, v in saved] == [None, True, "phase", "naive"] * 2
    yield
    for m, n, v in saved:
        setattr(m, n, v)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((B, 10), dtype=np.float32)
    cond = rng.standard_normal((B, 9), dtype=np.float32)
    params = JaxGenerator(width=1 / 16).init(
        {"params": jax.random.PRNGKey(0)}, noise, cond, False)["params"]
    return jax.tree_util.tree_map(np.array, params), noise, cond


def set_both(name, jax_value, port_value):
    setattr(J, name, jax_value)
    setattr(T, name, port_value)


def port_apply(params, noise, cond, **kw):
    return T.fast_generator_apply(tree_to_torch(params), torch.from_numpy(noise),
                                  torch.from_numpy(cond), int8=True, **kw).numpy()


@pytest.mark.parametrize("dq", [None, "bf16"])
def test_naive_conv0_stage_matches_jax(dq):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 18, 10, 32), dtype=np.float32)
    k = rng.standard_normal((4, 4, 32, 16), dtype=np.float32) * 0.1
    bias = rng.standard_normal(16, dtype=np.float32)
    if dq:
        set_both("DEQUANT_DTYPE", jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(J.upsample2_conv4_int8_naive(x, k, bias))
    out = T.upsample2_conv4_int8_naive(torch.from_numpy(x), T._quant_per_cout(torch.from_numpy(k)),
                                       torch.from_numpy(bias),
                                       dq=torch.bfloat16 if dq else torch.float32).numpy()
    assert out.shape == ref.shape == (2, 35, 19, 16)
    tol = 1e-2 if dq else 1e-5  # one bf16 rounding of the product and of the sum
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    # the naive form against the exact float conv: JAX's int8 rule (test_proton_fast.py:248)
    exact = T.fused_upsample2_conv4(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias))
    assert np.abs(out - exact.numpy()).max() <= 0.1 * float(exact.std())


@pytest.mark.parametrize("dq", [None, "bf16"])
def test_row_phase_conv1_and_dequant_stages_match_jax(dq):
    rng = np.random.default_rng(3)
    k4 = rng.standard_normal((4, 4, 32, 16), dtype=np.float32) * 0.1
    k3 = rng.standard_normal((3, 3, 32, 16), dtype=np.float32) * 0.1
    bias = rng.standard_normal(16, dtype=np.float32)
    x0 = rng.standard_normal((2, 18, 10, 32), dtype=np.float32)
    x1 = rng.standard_normal((2, 35, 19, 32), dtype=np.float32)
    x2 = rng.standard_normal((2, 55, 29, 32), dtype=np.float32)
    if dq:
        set_both("DEQUANT_DTYPE", jnp.bfloat16, torch.bfloat16)
    d = torch.bfloat16 if dq else torch.float32
    t = torch.from_numpy
    # eager where the dequant is bf16: XLA's CPU compiler drops a jitted
    # program's intermediate bf16 roundings
    row_phase = (J.fused_row_resize_conv4_int8 if dq
                 else jax.jit(J.fused_row_resize_conv4_int8, static_argnums=(3, 4)))
    q1 = T.quant_conv1_row_phases(t(k4))
    pairs = [
        (row_phase(x1, k4, bias, 56, 30),
         T.fused_row_resize_conv4_int8(t(x1), t(k4), t(bias), 56, 30, q=q1, dq=d)),
        (J.resize_conv4_int8_naive(x1, k4, bias, 56, 30),
         T.resize_conv4_int8_naive(t(x1), T._quant_per_cout(t(k4)), t(bias), 56, 30, dq=d)),
        (J.fused_upsample2_conv4_int8(x0, k4, bias),
         T.fused_upsample2_conv4_int8(t(x0), T.quant_conv0_phases(t(k4)), t(bias), dq=d)),
        (J.conv3x3_int8(x2, k3, bias), T.conv3x3_int8(t(x2), T._quant_per_cout(t(k3)), t(bias), dq=d)),
    ]
    if not dq:  # the float32 dequant of the last three: tests/test_torch_proton.py
        pairs = pairs[:1]
    tol = 1e-2 if dq else 1e-5
    for ref, out in pairs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    # the weights quantized once equal the inline quantization bit for bit
    assert torch.equal(T.fused_row_resize_conv4_int8(t(x1), t(k4), t(bias), 56, 30, dq=d),
                       pairs[0][1])


@pytest.mark.parametrize("setting", SETTINGS, ids=IDS)
def test_each_setting_matches_jax_with_the_same_setting(tiny, setting):
    params, noise, cond = tiny
    set_both(*setting)
    # jitted: one compile instead of one per op; the switch is read as it traces
    ref = np.asarray(jax.jit(lambda p, z, c: J.fast_generator_apply(p, z, c, int8=True))(
        params, noise, cond))
    out = port_apply(params, noise, cond)
    assert out.shape == ref.shape == (B, 56, 30, 1)
    bound = 0.05 * np.abs(ref).max() + 0.05
    err = np.abs(out - ref).max()
    print(f"{setting[0]}={setting[2]}: max |port - jax| = {err} (int8 bound {bound})")
    assert err < bound


@pytest.mark.parametrize("setting", SETTINGS, ids=IDS)
def test_quantized_weights_record_their_form(tiny, setting):
    """Weights quantized under the defaults keep decoding the default form
    after the switch flips (bit for bit); weights quantized after the flip
    decode the new form, which differs."""
    params, noise, cond = tiny
    p = tree_to_torch(params)
    q_default = T.quantize_weights(p, "xla")
    assert (q_default["dq"], q_default["conv0_impl"], q_default["conv1_impl"]) == (
        torch.float32, "phase", "naive")
    before = port_apply(params, noise, cond, qweights=q_default)
    set_both(*setting)
    q_new = T.quantize_weights(p, "xla")
    assert np.array_equal(port_apply(params, noise, cond, qweights=q_default), before)
    after = port_apply(params, noise, cond, qweights=q_new)
    assert np.array_equal(port_apply(params, noise, cond), after)  # quantized at the call
    assert not np.array_equal(after, before)
    name, _, value = setting
    recorded = {"DEQUANT_DTYPE": q_new["dq"], "INT8_CONV2": q_new["conv2"] is not None,
                "INT8_CONV0_IMPL": q_new["conv0_impl"], "INT8_CONV1_IMPL": q_new["conv1_impl"]}
    assert recorded[name] == ("phase" if value == "folded" else value)


def test_engine_keeps_its_form():
    """A ``FastSim`` built before a switch flips serves what it served."""
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim

    rng = np.random.default_rng(5)
    noise = rng.standard_normal((8, 10), dtype=np.float32)
    cond = rng.standard_normal((8, 9), dtype=np.float32)
    gen = JaxGenerator(width=0.125)
    one = gen.init({"params": jax.random.PRNGKey(3)}, noise[:1], cond[:1], False)["params"]
    stacked = jax.tree_util.tree_map(lambda a: np.stack([np.array(a)] * 3), one)
    router = {f"Dense_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a),
                             "bias": np.zeros(b, np.float32)}
              for i, (a, b) in enumerate([(9, 128), (128, 64), (64, 32), (32, 3)])}
    cfg = load_config(["model.generator.width=0.125"])
    built = FastSim(stacked, router, batch_size=8, precision="int8", device="cpu", cfg=cfg)
    ref = built.simulate_switch(cond, noise=noise)
    set_both("INT8_CONV0_IMPL", "naive", "naive")
    set_both("INT8_CONV1_IMPL", "phase", "phase")
    assert torch.equal(built.simulate_switch(cond, noise=noise), ref)
    fresh = FastSim(stacked, router, batch_size=8, precision="int8", device="cpu", cfg=cfg)
    assert not torch.equal(fresh.simulate_switch(cond, noise=noise), ref)


def test_unknown_form_raises(tiny):
    T.INT8_CONV1_IMPL = "winograd"
    with pytest.raises(ValueError, match="INT8_CONV1_IMPL"):
        T.quantize_weights(tree_to_torch(tiny[0]), "xla")


def test_conv_impl_selectors_at_full_width():
    """JAX's ``test_int8_conv_impl_selectors`` on the port: the full-width
    ``Generator`` from JAX's initialisation (PRNGKey 8) on 4 samples, the
    ("phase", "folded") forms against ("naive", "naive")."""
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), (4, 10)))
    cond = np.array(jax.random.normal(jax.random.fold_in(key, 2), (4, 9)))
    params = JaxGenerator().init({"params": jax.random.PRNGKey(8)}, noise, cond, False)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    T.INT8_CONV0_IMPL, T.INT8_CONV1_IMPL = "phase", "folded"
    a = port_apply(params, noise, cond)[..., 0]
    T.INT8_CONV0_IMPL, T.INT8_CONV1_IMPL = "naive", "naive"
    b = port_apply(params, noise, cond)[..., 0]
    assert a.shape == b.shape == (4, 56, 30)
    assert np.isfinite(b).all() and b.min() >= 0.0
    np.testing.assert_allclose(np.log1p(a.sum((1, 2))), np.log1p(b.sum((1, 2))), rtol=0.1)
