"""The port's 1-D Wasserstein distances (``zdcsim_torch.ops.ws``) against
scipy and the JAX package, on the CPU, at the tolerances of tests/test_ws.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import wasserstein_distance

from zdcsim.ops import ws as jws
from zdcsim_torch.ops import ws


@pytest.mark.parametrize("n,m", [(100, 100), (128, 64), (50, 173), (3, 7)])
def test_wasserstein_1d_matches_scipy(n, m):
    """Both branches: equal n (sorted differences) and unequal n (CDFs)."""
    rng = np.random.default_rng(n + m)
    u = rng.normal(2.0, 3.0, n).astype(np.float32)
    v = rng.normal(0.0, 1.0, m).astype(np.float32)
    got = float(ws.wasserstein_1d(torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_allclose(got, wasserstein_distance(u, v), rtol=1e-4)


def test_wasserstein_1d_of_identical_samples_is_zero():
    u = torch.rand(64)
    assert float(ws.wasserstein_1d(u, u.clone())) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("n,m", [(200, 150), (256, 256)])
def test_wasserstein_per_channel_matches_jax(n, m):
    rng = np.random.default_rng(n + m)
    a = rng.normal(size=(n, 5)).astype(np.float32)
    b = rng.normal(loc=1.0, size=(m, 5)).astype(np.float32)
    got = ws.wasserstein_per_channel(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jws.wasserstein_per_channel(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (5,)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, [wasserstein_distance(a[:, i], b[:, i]) for i in range(5)],
                               rtol=1e-3, atol=1e-4)


def test_masked_wasserstein_matches_jax_and_the_dense_subset():
    rng = np.random.default_rng(4)
    u = rng.normal(size=128).astype(np.float32)
    v = rng.normal(loc=0.5, size=128).astype(np.float32)
    um = (rng.random(128) < 0.6).astype(np.float32)
    vm = (rng.random(128) < 0.4).astype(np.float32)
    got = float(ws.masked_wasserstein_1d(*(torch.from_numpy(t) for t in (u, um, v, vm))))
    ref = float(jws.masked_wasserstein_1d(*(jnp.asarray(t) for t in (u, um, v, vm))))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, wasserstein_distance(u[um > 0], v[vm > 0]),
                               rtol=1e-3, atol=1e-4)


def test_masked_wasserstein_of_an_empty_mask_is_zero():
    u, v = torch.randn(64), torch.randn(64)
    empty, full = torch.zeros(64), torch.ones(64)
    assert float(ws.masked_wasserstein_1d(u, empty, v, full)) == 0.0
    assert float(ws.masked_wasserstein_1d(u, full, v, empty)) == 0.0
    assert float(ws.masked_wasserstein_1d(u, empty, v, empty)) == 0.0
