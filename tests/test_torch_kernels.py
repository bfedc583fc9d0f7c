"""The plain versions of the port's decode kernels against the JAX Pallas
kernels (interpret mode on the CPU): ``zdcsim_torch/ops/decode_kernels.py``
vs ``zdcsim/ops/pallas_decode.py``. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.ops import pallas_decode as jpd
from zdcsim_torch.ops import decode_kernels as dk


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_ln_leaky_rowquant_matches_jax():
    b, f = 16, 1024
    rng = np.random.default_rng(0)
    y = rng.standard_normal((b, f), dtype=np.float32) * 3.0
    scale = rng.standard_normal(f, dtype=np.float32) * 0.5 + 1.0
    bias = rng.standard_normal(f, dtype=np.float32) * 0.2
    qj, sj = jpd.ln_leaky_rowquant(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias),
                                   interpret=True)
    q, s = dk.ln_leaky_rowquant(torch.from_numpy(y), torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert q.shape == (b, f) and q.dtype == torch.int8 and s.shape == (b, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6)
    # bounds of tests/test_pallas_decode.py:36-44: at most round-boundary flips
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert (diff <= 1).all() and (diff != 0).mean() < 0.01


def test_quant_phases_bit_equal():
    w = np.random.default_rng(1).standard_normal((4, 4, 16, 8), dtype=np.float32) * 0.1
    kqj, skj = jpd._quant_phases(jnp.asarray(w))
    kq, sk = dk._quant_phases(torch.from_numpy(w))
    assert kq.shape == (25, 16, 8) and kq.dtype == torch.int8 and sk.shape == (4, 8)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kqj))
    np.testing.assert_allclose(sk.numpy(), np.asarray(skj), rtol=1e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_up2_conv4_int8_matches_jax(out_dtype):
    b, h, w, cin, cout = 4, 6, 4, 16, 8
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    sx = (np.abs(rng.standard_normal(b)) * 0.01 + 1e-3).astype(np.float32)
    kernel = rng.standard_normal((4, 4, cin, cout), dtype=np.float32) * 0.1
    bias = rng.standard_normal(cout, dtype=np.float32) * 0.5
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = jpd.up2_conv4_int8(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(kernel),
                             jnp.asarray(bias), out_dtype=jdt, block_rows=2, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    kq, sk = dk._quant_phases(torch.from_numpy(kernel))
    out = dk.up2_conv4_int8(torch.from_numpy(xq), torch.from_numpy(sx), dk.pack_k_major(kq), sk,
                            torch.from_numpy(bias), out_dtype=out_dtype)
    assert out.shape == (b, 2 * h - 1, 2 * w - 1, cout) and out.dtype == out_dtype
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    a0, b0 = dk.ln_leaky_rowquant.launches, dk.up2_conv4_int8.launches
    y = torch.randn(2, 64)
    q, s = dk.ln_leaky_rowquant(y, torch.ones(64), torch.zeros(64))
    qp, sp = dk.ln_leaky_rowquant_plain(y, torch.ones(64), torch.zeros(64))
    assert torch.equal(q, qp) and torch.equal(s, sp)
    kq, sk = dk._quant_phases(torch.randn(4, 4, 8, 4))
    kp = dk.pack_k_major(kq)
    xq = torch.randint(-127, 128, (1, 3, 2, 8), dtype=torch.int8)
    out = dk.up2_conv4_int8(xq, torch.ones(1), kp, sk, torch.zeros(4))
    assert torch.equal(out, dk.up2_conv4_int8_plain(xq, torch.ones(1), kp, sk, torch.zeros(4)))
    assert (dk.ln_leaky_rowquant.launches, dk.up2_conv4_int8.launches) == (a0, b0)


def test_wrappers_require_float32_parameters():
    """Per-channel parameters are cast to f32 once, by the caller; a wrapper
    given another dtype raises on the CPU as on the card."""
    with pytest.raises(ValueError, match="scale must be float32"):
        dk.ln_leaky_rowquant(torch.randn(2, 64), torch.ones(64, dtype=torch.bfloat16),
                             torch.zeros(64))
    kq, sk = dk._quant_phases(torch.randn(4, 4, 8, 4))
    xq = torch.zeros((1, 3, 2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="bias must be float32"):
        dk.up2_conv4_int8(xq, torch.ones(1), dk.pack_k_major(kq), sk,
                          torch.zeros(4, dtype=torch.bfloat16))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from zdcsim_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("h,w", [(18, 10), (3, 2)])
def test_chip_smoke_counts_the_in_grid_taps_of_kernel_b(h, w):
    """``chip_smoke.in_grid_taps`` (kernel B's operation count) equals the
    plain version's output on all-ones data: each output sums its taps that
    read the source grid."""
    import chip_smoke

    kq = torch.ones((25, 1, 1), dtype=torch.int8)
    out = dk.up2_conv4_int8_plain(torch.ones((1, h, w, 1), dtype=torch.int8), torch.ones(1),
                                  dk.pack_k_major(kq), torch.ones((4, 1)), torch.zeros(1),
                                  out_dtype=torch.float32)
    assert chip_smoke.in_grid_taps(h, w) == int(out.sum())
