"""Kernels C (GroupNorm + quant) and D (row-resize Conv_1) of the
``int8_pallas`` path, and that path end to end, against the JAX package.

JAX runs its Pallas kernels in interpret mode on the CPU; the port runs the
plain versions of its CUDA kernels, which a CPU tensor selects. Inputs are
made with numpy from a seed. The decode and engine tests share one
module-scoped load of the full-width proton teacher
(``artifacts/gate/gate_serving_weights.npz``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zdcsim.models.proton_fast as J
from zdcsim.ops import pallas_decode as jpd
from zdcsim.utils.artifact import load_serving_artifact as jax_load
import zdcsim_torch.models.proton_fast as T
from zdcsim_torch.convert import expert, from_jax_params
from zdcsim_torch.ops import decode_kernels as dk

TEACHER = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                       "gate_serving_weights.npz")
B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _int8_bound(ref):
    """Bound of tests/test_pallas_decode.py:203 for int8 paths, where a
    rounding flip of one activation cascades through the later convs."""
    return 0.05 * float(np.abs(ref).max()) + 0.05


@pytest.mark.parametrize("plan", [(35, 56, 4, 1), (19, 30, 4, 1), (5, 8, 3, 1)])
def test_row_phase_plan_equals_jax(plan):
    q, p, plans = T._row_phase_plan(*plan)
    qj, pj, plans_j = J._row_phase_plan(*plan)
    assert (q, p) == (qj, pj) and len(plans) == len(plans_j) == q
    for (d0, groups, n), (d0j, groups_j, nj) in zip(plans, plans_j):
        assert (d0, n) == (d0j, nj)
        assert [(int(d), list(t)) for d, t in groups] == [(int(d), list(t)) for d, t in groups_j]
    if plan == (35, 56, 4, 1):
        assert (q, p) == (8, 5)
        assert [len(g) for _, g, _ in plans] == [3] * 7 + [2]
        assert [n for _, _, n in plans] == [7] * 7 + [6]


def test_quant_row_phases_bit_equal():
    w = np.random.default_rng(1).standard_normal((4, 4, 16, 8), dtype=np.float32) * 0.1
    plans = J._row_phase_plan(35, 56, 4, 1)[2]
    kqj, skj, offj, max_l = jpd._quant_row_phases(jnp.asarray(w), plans)
    kq, sk, offsets = dk._quant_row_phases(torch.from_numpy(w), T._row_phase_plan(35, 56, 4, 1)[2])
    assert kq.shape == (8, 12, 16, 8) and kq.dtype == torch.int8 and sk.shape == (8, 8)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kqj))
    np.testing.assert_allclose(sk.numpy(), np.asarray(skj), rtol=1e-6)
    assert offsets == [[int(d) for d in row] for row in offj] and max_l == 3


@pytest.mark.parametrize("shape", [(4, 5, 3, 64), (2, 35, 19, 256)])
def test_gn_leaky_rowquant_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape, dtype=np.float32) * 2.0
    c = shape[-1]
    scale = np.abs(rng.standard_normal(c, dtype=np.float32)) + 0.5
    bias = rng.standard_normal(c, dtype=np.float32) * 0.3
    qj, sj = jpd.gn_leaky_rowquant(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                   groups=32, block_rows=2, interpret=True)
    q, s = dk.gn_leaky_rowquant(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert q.shape == shape and q.dtype == torch.int8 and s.shape == (shape[0], 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    # the statistics are summed in another order: at most round-boundary flips
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def _fma_f32(a, b, c):
    """``a * b + c`` of float32 arrays with one rounding, as a fused
    multiply-add gives it: the product is exact in float64 (24 + 24 bits),
    the sum's rounding error is recovered exactly (TwoSum), and a float64 sum
    that falls exactly between two float32 values rounds toward that error."""
    a, b, c = (np.asarray(t, np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    mid = (r.astype(np.float64) + other.astype(np.float64)) * 0.5 == s
    toward = np.sign(err) == np.sign(other.astype(np.float64) - r.astype(np.float64))
    return np.where(mid & (err != 0) & toward, other, r)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,cin,cout", [(2, 6, 8, 4), (2, 30, 256, 128)])
def test_row_resize_conv4_int8_matches_jax(b, w, cin, cout, out_dtype):
    rng = np.random.default_rng(cin + cout)
    xq = rng.integers(-127, 128, (b, 35, w, cin), dtype=np.int8)
    sx = (np.abs(rng.standard_normal(b)) * 0.01 + 1e-3).astype(np.float32)
    kernel = rng.standard_normal((4, 4, cin, cout), dtype=np.float32) * 0.1
    bias = rng.standard_normal(cout, dtype=np.float32) * 0.5
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = jpd.row_resize_conv4_int8(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(kernel),
                                    jnp.asarray(bias), 56, out_dtype=jdt, block_rows=2,
                                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    kq, sk, offsets = dk._quant_row_phases(torch.from_numpy(kernel),
                                           T._row_phase_plan(35, 56, 4, 1)[2])
    kp = dk.pack_k_major(kq)
    out = dk.row_resize_conv4_int8(torch.from_numpy(xq), torch.from_numpy(sx), kp, sk, offsets,
                                   torch.from_numpy(bias), 56, out_dtype=out_dtype)
    assert out.shape == (b, 55, w, cout) and out.dtype == out_dtype
    if out_dtype == torch.float32:
        # tolerance of test_up2_conv4_int8_matches_int32_exact_reference
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        # Where the two differ, they differ by the epilogue's rounding: with
        # sx = 1 and bias = 0 both give t = f32(acc * sk), bit for bit; the
        # port then rounds twice, f32(f32(t * sx) + bias), in the written
        # order, while XLA's CPU backend fuses t * sx + bias into one FMA.
        ones, zeros = np.ones_like(sx), np.zeros_like(bias)
        t = dk.row_resize_conv4_int8(torch.from_numpy(xq), torch.from_numpy(ones), kp, sk,
                                     offsets, torch.from_numpy(zeros), 56,
                                     out_dtype=torch.float32).numpy()
        t_jax = np.asarray(jpd.row_resize_conv4_int8(
            jnp.asarray(xq), jnp.asarray(ones), jnp.asarray(kernel), jnp.asarray(zeros), 56,
            out_dtype=jnp.float32, block_rows=2, interpret=True))
        np.testing.assert_array_equal(t, t_jax)
        sxb = sx.reshape(b, 1, 1, 1)
        np.testing.assert_array_equal(out.numpy(), (t * sxb).astype(np.float32) + bias)
        np.testing.assert_array_equal(ref, _fma_f32(t, sxb, bias))
    else:
        # XLA fuses the f32 epilogue's t * sx + bias into one FMA (the f32
        # case shows it), which can move a value to the neighbouring bf16:
        # one bf16 ulp
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= ulp).all()


def test_row_resize_conv4_int8_rejects_other_plans():
    kq, sk, offsets = dk._quant_row_phases(torch.randn(4, 4, 8, 8),
                                           T._row_phase_plan(35, 56, 4, 1)[2])
    xq = torch.zeros((1, 19, 30, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="stride-5"):
        dk.row_resize_conv4_int8(xq, torch.ones(1), dk.pack_k_major(kq), sk, offsets,
                                 torch.zeros(8), 30)


@pytest.mark.parametrize("fn", ["fused_row_resize_conv4", "fused_row_resize_conv4_int8"])
def test_folded_row_resize_convs_match_jax(fn):
    """The float row-phase form (kernel D's float reference) and its XLA
    int8 twin, 35x19 -> 56x30 -> 55x29."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 35, 19, 16), dtype=np.float32)
    kernel = rng.standard_normal((4, 4, 16, 8), dtype=np.float32) * 0.1
    bias = rng.standard_normal(8, dtype=np.float32)
    ref = np.asarray(getattr(J, fn)(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), 56, 30))
    out = getattr(T, fn)(torch.from_numpy(x), torch.from_numpy(kernel), torch.from_numpy(bias),
                         56, 30).numpy()
    assert out.shape == ref.shape == (2, 55, 29, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_folded_row_resize_conv4_equals_resize_then_conv():
    """The fold is exact: the row-phase form equals the materialised nearest
    resize followed by the 4x4 pad-1 conv."""
    from zdcsim_torch.models.layers import resize_nearest

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 35, 19, 8), dtype=np.float32))
    kernel = torch.from_numpy(rng.standard_normal((4, 4, 8, 4), dtype=np.float32))
    bias = torch.zeros(4)
    ref = T._conv(resize_nearest(x, (56, 30)), kernel, ((1, 1), (1, 1)))
    out = T.fused_row_resize_conv4(x, kernel, bias, 56, 30)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_cpu_calls_of_c_and_d_run_the_plain_versions_and_count_no_launch():
    c0, d0 = dk.gn_leaky_rowquant.launches, dk.row_resize_conv4_int8.launches
    x = torch.randn(2, 5, 3, 64)
    q, s = dk.gn_leaky_rowquant(x, torch.ones(64), torch.zeros(64))
    qp, sp = dk.gn_leaky_rowquant_plain(x, torch.ones(64), torch.zeros(64))
    assert torch.equal(q, qp) and torch.equal(s, sp)
    kq, sk, offsets = dk._quant_row_phases(torch.randn(4, 4, 8, 8),
                                           T._row_phase_plan(35, 56, 4, 1)[2])
    xq = torch.randint(-127, 128, (1, 35, 4, 8), dtype=torch.int8)
    args = (xq, torch.ones(1), dk.pack_k_major(kq), sk, offsets, torch.zeros(8), 56)
    assert torch.equal(dk.row_resize_conv4_int8(*args), dk.row_resize_conv4_int8_plain(*args))
    assert (dk.gn_leaky_rowquant.launches, dk.row_resize_conv4_int8.launches) == (c0, d0)
    with pytest.raises(ValueError, match="bias must be float32"):
        dk.gn_leaky_rowquant(x, torch.ones(64), torch.zeros(64, dtype=torch.bfloat16))


def test_chip_smoke_counts_the_in_grid_taps_of_kernel_d():
    """``chip_smoke.row_resize_taps`` (kernel D's operation count) equals the
    plain version's output on all-ones data with the merged all-ones
    kernel: each output sums the taps that read the source grid."""
    import chip_smoke

    kq, sk, offsets = dk._quant_row_phases(torch.ones((4, 4, 1, 1)),
                                           T._row_phase_plan(35, 56, 4, 1)[2])
    xq = torch.ones((1, 35, 30, 1), dtype=torch.int8)
    out = dk.row_resize_conv4_int8_plain(xq, torch.ones(1),
                                         dk.pack_k_major((kq != 0).to(torch.int8)),
                                         torch.ones_like(sk), offsets, torch.zeros(1), 56,
                                         out_dtype=torch.float32)
    assert chip_smoke.row_resize_taps(35, 30, 56) == int(out.sum())


# ---------------------------------------------------------------------------
# The int8_pallas path on the full-width teacher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def teacher():
    gp, _, rp, _ = jax_load(TEACHER)
    return gp, rp


def test_fast_generator_pallas_matches_jax(teacher):
    from zdcsim_torch.models.proton_fast import fast_generator_apply

    gp, _ = teacher
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((B, 10)).astype(np.float32)
    cond = rng.standard_normal((B, 9)).astype(np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], gp)
    ref = np.asarray(J.fast_generator_apply(p0, jnp.asarray(noise), jnp.asarray(cond), int8=True,
                                            int8_backend="pallas"))
    gen, _ = from_jax_params(gp, {})
    out = fast_generator_apply(expert(gen, 0), torch.from_numpy(noise), torch.from_numpy(cond),
                               int8=True, int8_backend="pallas").numpy()
    assert out.shape == ref.shape == (B, 56, 30, 1)
    err = np.abs(out - ref).max()
    print(f"pallas max |port - jax| = {err} (int8 bound {_int8_bound(ref)})")
    assert err < _int8_bound(ref)


def test_fastsim_int8_pallas_matches_jax_engine(teacher):
    """The slice end to end: router, tiled-switch dispatch, the four-kernel
    decode and expm1, through ``simulate_switch`` at B=4, tile 4."""
    from zdcsim.config import load_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim_torch.inference.engine import FastSim

    gp, rp = teacher
    cond = np.random.default_rng(3).standard_normal((B, 9)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jeng = JaxFastSim(build_moe(load_config(overrides=["model.n_experts=3"])), gp, {}, rp,
                      batch_size=B, precision="int8_pallas")
    jeng._build_switch(tile=4)
    ref, ref_ids = jeng.simulate_switch(cond, key, return_experts=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    # the JAX engine's own noise: sim_switch draws it from the chunk key
    # fold_in(key, 0) (engine.py:412 and :485)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, 10), jnp.bfloat16)
                       .astype(jnp.float32))

    eng = FastSim(gp, rp, batch_size=B, precision="int8_pallas", device="cpu")
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    out, ids = out.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ref_ids)
    assert out.shape == ref.shape == (B, 56, 30)
    assert np.isfinite(out).all() and out.min() >= 0.0
    log_ref, log_out = np.log1p(ref), np.log1p(out)
    err = np.abs(log_out - log_ref).max()
    print(f"FastSim max |log1p port - log1p jax| = {err} (int8 bound {_int8_bound(log_ref)})")
    assert err < _int8_bound(log_ref)
