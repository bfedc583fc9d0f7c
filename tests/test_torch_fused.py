"""Kernels G (``fused_decode_front``) and H (``fused_decode``) of the
``int8_fused_front`` and ``int8_fused`` paths, and both paths end to end,
against the JAX package.

JAX runs its Pallas kernels in interpret mode on the CPU; the port runs the
plain versions of its CUDA kernels, which a CPU tensor selects. Inputs are
made with numpy from a seed. The tests share one module-scoped load of the
full-width proton teacher (``artifacts/gate/gate_serving_weights.npz``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zdcsim.models.proton_fast as J
from zdcsim.ops import pallas_decode_fused as jpf
from zdcsim.utils.artifact import load_serving_artifact as jax_load
import zdcsim_torch.models.proton_fast as T
from zdcsim_torch.convert import expert, from_jax_params, from_state_dict, tree_to_torch
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.ops import fused_decode_kernels as fdk

TEACHER = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                       "gate_serving_weights.npz")
EXPERT = 1  # the expert the teacher's router sends every condition to


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


@pytest.fixture(scope="module")
def teacher():
    gp, _, rp, _ = jax_load(TEACHER)
    return gp, rp


@pytest.fixture(scope="module")
def expert_f32(teacher):
    """Expert 1 in f32 for both packages, and the Dense_1 output of 3
    showers from numpy-seeded noise and conditions through the MLP."""
    gp, _ = teacher
    p_jax = jax.tree_util.tree_map(lambda a: jnp.asarray(a[EXPERT], jnp.float32), gp)
    p_t = tree_to_torch(expert(from_jax_params(gp, {})[0], EXPERT))
    rng = np.random.default_rng(17)
    noise = torch.from_numpy(rng.standard_normal((3, 10), dtype=np.float32))
    cond = torch.from_numpy(rng.standard_normal((3, 9), dtype=np.float32))
    x = T.mlp_apply(p_t, noise, cond).numpy()
    assert x.shape == (3, 92160)
    return p_jax, p_t, x


def test_geometry_and_resize_maps_equal_jax():
    assert (fdk.H0, fdk.W0, fdk.C0, fdk.H1, fdk.W1, fdk.C1, fdk.HG, fdk.WG, fdk.C2, fdk.C3) == (
        jpf.H0, jpf.W0, jpf.C0, jpf.H1, jpf.W1, jpf.C1, jpf.HG, jpf.WG, jpf.C2, jpf.C3)
    np.testing.assert_array_equal(fdk._ROW_MAP, jpf._ROW_MAP)
    np.testing.assert_array_equal(fdk._COL_MAP, jpf._COL_MAP)
    # the kernel's integer form floor((2i + 1) * in / (2 * out)) of the same maps
    i, j = np.arange(fdk.HG), np.arange(fdk.WG)
    np.testing.assert_array_equal((2 * i + 1) * fdk.H1 // (2 * fdk.HG), fdk._ROW_MAP)
    np.testing.assert_array_equal((2 * j + 1) * fdk.W1 // (2 * fdk.WG), fdk._COL_MAP)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 4, 256, 128), (3, 3, 128, 64), (2, 2, 64, 1)])
def test_quant_cout_bit_equal_to_jax(shape, dtype):
    w = np.random.default_rng(shape[-1]).standard_normal(shape, dtype=np.float32) * 0.1
    wj = jnp.asarray(w).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    kqj, skj = jpf._quant_cout(wj)
    kq, sk = fdk._quant_cout(wt)
    assert kq.dtype == torch.int8 and kq.shape == shape and sk.shape == (shape[-1],)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kqj))
    np.testing.assert_allclose(sk.numpy(), np.asarray(skj), rtol=1e-6)
    assert T._quant_per_cout is fdk._quant_cout


@pytest.mark.parametrize("b", [2, 3])
def test_fused_decode_front_plain_matches_jax(expert_f32, b):
    """B=3 makes JAX halve its sample block down to 1."""
    p_jax, p_t, x = expert_f32
    qj, sj = jpf.fused_decode_front_from_params(p_jax, jnp.asarray(x[:b]), interpret=True)
    weights = fdk.front_weights(p_t)
    q, s = fdk.fused_decode_front_plain(torch.from_numpy(x[:b]), *weights)
    assert q.shape == (b, 56, 30, 256) and q.dtype == torch.int8
    assert s.shape == (b,) and s.dtype == torch.float32
    s_rel = np.abs(s.numpy() - np.asarray(sj)) / np.asarray(sj)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    print(f"G: max s rel err {s_rel.max():.3e}, max |q - q_jax| {diff.max()}, "
          f"flips {(diff != 0).mean():.3e}")
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    # the statistics are summed in another order: at most round-boundary flips
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def test_fused_decode_plain_matches_jax(expert_f32):
    p_jax, p_t, x = expert_f32
    xb = x[:2]
    ref = np.asarray(jpf.fused_decode_from_params(p_jax, jnp.asarray(xb), interpret=True))
    weights = fdk.front_weights(p_t) + fdk.tail_weights(p_t)
    out = fdk.fused_decode_plain(torch.from_numpy(xb), *weights)
    assert out.shape == ref.shape == (2, 56, 30) and out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max()
    print(f"H: max |port - jax| = {err} (int8 bound {_int8_bound(ref)})")
    assert err < _int8_bound(ref)
    counts = fdk.fused_decode_plain(torch.from_numpy(xb), *weights, apply_expm1=True)
    np.testing.assert_allclose(np.expm1(out.numpy()), counts.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["fused_front", "fused"])
def test_fast_generator_fused_backends_match_jax(teacher, backend):
    """The engine's bf16 tree at B=4, as tests/test_pallas_fused.py:69,132
    drive the backends."""
    gp, _ = teacher
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((4, 10)).astype(np.float32)
    cond = rng.standard_normal((4, 9)).astype(np.float32)
    p_jax = jax.tree_util.tree_map(lambda a: jnp.asarray(a[EXPERT], jnp.bfloat16), gp)
    ref = J.fast_generator_apply(p_jax, jnp.asarray(noise, jnp.bfloat16),
                                 jnp.asarray(cond, jnp.bfloat16), int8=True, int8_backend=backend)
    ref = np.asarray(ref.astype(jnp.float32))
    p_t = tree_to_torch(expert(from_jax_params(gp, {})[0], EXPERT), dtype=torch.bfloat16)
    out = T.fast_generator_apply(p_t, torch.from_numpy(noise).to(torch.bfloat16),
                                 torch.from_numpy(cond).to(torch.bfloat16), int8=True,
                                 int8_backend=backend)
    assert out.shape == ref.shape == (4, 56, 30, 1) and out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    print(f"{backend} max |port - jax| = {err} (int8 bound {_int8_bound(ref)})")
    assert err < _int8_bound(ref)


@pytest.mark.parametrize("precision", ["int8_fused_front", "int8_fused"])
def test_fastsim_fused_matches_jax_engine(teacher, precision):
    """The slice end to end: router, tiled-switch dispatch, the fused decode
    and expm1, through ``simulate_switch`` at B=4, tile 4."""
    from zdcsim.config import load_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim_torch.inference.engine import FastSim

    gp, rp = teacher
    b = 4
    cond = np.random.default_rng(3).standard_normal((b, 9)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jeng = JaxFastSim(build_moe(load_config(overrides=["model.n_experts=3"])), gp, {}, rp,
                      batch_size=b, precision=precision)
    jeng._build_switch(tile=4)
    ref, ref_ids = jeng.simulate_switch(cond, key, return_experts=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    # the JAX engine's own noise: sim_switch draws it from the chunk key
    # fold_in(key, 0) (engine.py:412 and :485)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (b, 10), jnp.bfloat16)
                       .astype(jnp.float32))

    eng = FastSim(gp, rp, batch_size=b, precision=precision, device="cpu")
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    out, ids = out.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ref_ids)
    assert out.shape == ref.shape == (b, 56, 30)
    assert np.isfinite(out).all() and out.min() >= 0.0
    log_ref, log_out = np.log1p(ref), np.log1p(out)
    err = np.abs(log_out - log_ref).max()
    print(f"FastSim {precision} max |log1p port - log1p jax| = {err} "
          f"(int8 bound {_int8_bound(log_ref)})")
    assert err < _int8_bound(log_ref)


def test_cpu_calls_run_the_plain_versions_and_count_no_launch(expert_f32):
    _, p_t, x = expert_f32
    g0, h0 = fdk.fused_decode_front.launches, fdk.fused_decode.launches
    xt = torch.from_numpy(x[:1])
    front, tail = fdk.front_weights(p_t), fdk.tail_weights(p_t)
    q, s = fdk.fused_decode_front_from_params(p_t, xt)
    qp, sp = fdk.fused_decode_front_plain(xt, *front)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(fdk.fused_decode_from_params(p_t, xt, apply_expm1=True),
                       fdk.fused_decode_plain(xt, *front, *tail, apply_expm1=True))
    assert (fdk.fused_decode_front.launches, fdk.fused_decode.launches) == (g0, h0)
    with pytest.raises(ValueError, match="b0 must be float32"):
        fdk.fused_decode_front(xt, *front[:4], front[4].to(torch.bfloat16), *front[5:])
    with pytest.raises(ValueError, match=r"x must be \[B, 92160\]"):
        fdk.fused_decode(xt[:, :1000], *front, *tail)
    with pytest.raises(ValueError, match="kq2 must be"):
        fdk.fused_decode(xt, *front, *tail[:5], tail[5][:2], *tail[6:])


def test_narrow_trees_are_refused():
    """C0..C3 are fixed in the kernels, as in JAX: a width-1/16 tree raises in
    the weights, in the wrappers and in ``FastSim`` on both fused
    precisions."""
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.router import RouterNetwork
    from zdcsim_torch.utils.artifact import _flatten, _unflatten

    torch.manual_seed(0)
    tree = from_state_dict(Generator(width=1 / 16).state_dict())
    p = tree_to_torch(tree)
    with pytest.raises(ValueError, match="full width"):
        fdk.front_weights(p)
    x = torch.zeros((2, 18 * 10 * 32))
    ln, gn = p["MLPBlock_1"]["LayerNorm_0"], p["GroupNorm2d_0"]["GroupNorm_0"]
    kq0, sk0 = T.dk._quant_phases(p["Conv_0"]["kernel"])
    with pytest.raises(ValueError, match="full width"):
        fdk.fused_decode_front(x, ln["scale"], ln["bias"], kq0, sk0, p["Conv_0"]["bias"],
                               gn["scale"], gn["bias"])
    flat = _flatten(tree)
    gen = _unflatten({k: np.stack([flat[k]] * 3) for k in flat})
    router = from_state_dict(RouterNetwork(3).state_dict())
    for precision in ("int8_fused_front", "int8_fused"):
        with pytest.raises(ValueError, match="full width"):
            FastSim(gen, router, precision=precision, device="cpu")


def test_chip_smoke_counts_the_in_grid_taps_of_convs_1_and_2():
    """``chip_smoke.pad1_taps`` (the operation count of H's Conv_1 and
    Conv_2) equals the plain conv's output on all-ones data with an all-ones
    kernel: each output sums the taps that read the source grid."""
    import chip_smoke

    for (h, w), k in (((56, 30), 4), ((55, 29), 3)):
        ones = torch.ones((1, h, w, 1), dtype=torch.int8)
        out = fdk._conv_pad1_exact(ones, torch.ones((k, k, 1, 1), dtype=torch.int8), (55, 29))
        assert chip_smoke.pad1_taps(h, w, k) == int(out.sum())
