"""``zdcsim_torch.inference.switch_dispatch.tiled_switch_decode`` with toy
decoders (mirror of tests/test_switch_dispatch.py), and against the JAX
dispatch on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.inference.switch_dispatch import tiled_switch_decode as jax_decode
from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode


def _decoders(e_count, out_shape, calls=None):
    """Expert e multiplies (noise + cond-sum) by (e+1)."""
    def make(e):
        def decode(z, c):
            if calls is not None:
                calls.append((e, z.shape[0]))
            base = z.sum(dim=1) + c.sum(dim=1)
            return (e + 1.0) * base[:, None, None] * torch.ones((1, *out_shape))
        return decode
    return [make(e) for e in range(e_count)]


def _reference(idx, cond, noise, out_shape):
    base = noise.sum(axis=1) + cond.sum(axis=1)
    return ((idx + 1.0) * base)[:, None, None] * np.ones((1, *out_shape))


def _inputs(seed, b, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, e, b), rng.standard_normal((b, 9), dtype=np.float32),
            rng.standard_normal((b, 10), dtype=np.float32))


@pytest.mark.parametrize("seed,tile", [(0, 4), (1, 8), (2, 16)])
def test_switch_decode_matches_reference(seed, tile):
    idx, cond, noise = _inputs(seed, 32, 3)
    out = tiled_switch_decode(_decoders(3, (4, 3)), torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (4, 3), tile=tile)
    np.testing.assert_allclose(out.numpy(), _reference(idx, cond, noise, (4, 3)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,tile", [(3, 4), (4, 8)])
def test_switch_decode_matches_jax_dispatch(seed, tile):
    """Same grouping, same pad replication, same scatter as the JAX
    in-scan-scatter dispatch."""
    idx, cond, noise = _inputs(seed, 32, 3)
    jfns = [lambda z, c, e=e: (e + 1.0) * (z.sum(axis=1) + c.sum(axis=1))[:, None, None]
            * jnp.ones((1, 4, 3)) for e in range(3)]
    ref = jax_decode(jfns, jnp.asarray(idx), jnp.asarray(cond), jnp.asarray(noise), (4, 3),
                     tile=tile, in_scan_scatter=True)
    out = tiled_switch_decode(_decoders(3, (4, 3)), torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (4, 3), tile=tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_switch_decode_all_one_expert():
    b = 16
    idx = np.full(b, 2)
    cond, noise = np.ones((b, 9), np.float32), np.ones((b, 10), np.float32)
    out = tiled_switch_decode(_decoders(4, (2, 2)), torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (2, 2), tile=4)
    np.testing.assert_allclose(out.numpy(), _reference(idx, cond, noise, (2, 2)), rtol=1e-5)


def test_switch_decode_empty_experts_decode_nothing():
    b = 16
    idx = np.asarray([0, 4] * 8)  # experts 1..3 empty
    _, cond, noise = _inputs(5, b, 5)
    calls = []
    out = tiled_switch_decode(_decoders(5, (2, 2), calls), torch.from_numpy(idx),
                              torch.from_numpy(cond), torch.from_numpy(noise), (2, 2), tile=4)
    np.testing.assert_allclose(out.numpy(), _reference(idx, cond, noise, (2, 2)),
                               rtol=1e-5, atol=1e-5)
    assert sorted(calls) == [(0, 4), (0, 4), (4, 4), (4, 4)]


def test_switch_decode_pads_a_partial_tile_with_replicas():
    """A segment that is not a multiple of the tile is padded with copies of
    its last sample; the scatter writes each sample once with its own value."""
    idx = np.asarray([1, 0, 1, 1, 0, 1, 1, 1])  # expert 0: 2 samples, expert 1: 6
    _, cond, noise = _inputs(6, 8, 2)
    seen = []

    def dec(e):
        def f(z, c):
            seen.append((e, z.clone()))
            return (z.sum(dim=1) + c.sum(dim=1))[:, None, None] * torch.ones((1, 1, 1))
        return f

    out = tiled_switch_decode([dec(0), dec(1)], torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (1, 1), tile=4)
    np.testing.assert_allclose(out.numpy()[:, 0, 0], noise.sum(1) + cond.sum(1), rtol=1e-6)
    # expert 0's tile: its 2 samples (rows 1, 4), then row 4 twice more
    e0 = [z for e, z in seen if e == 0][0]
    np.testing.assert_array_equal(e0.numpy(), noise[[1, 4, 4, 4]])


def test_switch_decode_rejects_indivisible_tile():
    with pytest.raises(ValueError):
        tiled_switch_decode(_decoders(2, (2, 2)), torch.zeros(10, dtype=torch.long),
                            torch.zeros((10, 9)), torch.zeros((10, 10)), (2, 2), tile=4)
