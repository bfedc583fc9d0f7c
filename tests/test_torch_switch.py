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


def _dyn(out_shape, calls=None):
    """Branchless counterpart of :func:`_decoders`: the chunk's expert comes
    in as a 0-d tensor."""
    def decode_dyn(e_k, z, c):
        if calls is not None:
            calls.append(z.shape[0])
        base = z.sum(dim=1) + c.sum(dim=1)
        return (e_k + 1.0) * base[:, None, None] * torch.ones((1, *out_shape))
    return decode_dyn


@pytest.mark.parametrize("seed,tile", [(11, 8), (12, 4)])
def test_switch_decode_dyn_bit_matches_switch(seed, tile):
    """decode_dyn reproduces the per-expert path bit for bit (mirror of
    tests/test_switch_dispatch.py::test_switch_decode_dyn_bit_matches)."""
    idx, cond, noise = _inputs(seed, 32, 3)
    args = (torch.from_numpy(idx), torch.from_numpy(cond), torch.from_numpy(noise), (4, 3))
    via_switch = tiled_switch_decode(_decoders(3, (4, 3)), *args, tile=tile)
    via_dyn = tiled_switch_decode(_decoders(3, (4, 3)), *args, tile=tile, decode_dyn=_dyn((4, 3)))
    assert torch.equal(via_switch, via_dyn)


def test_switch_decode_dyn_matches_jax_dyn_dispatch():
    idx, cond, noise = _inputs(13, 32, 3)

    def jdyn(e_k, z, c):
        base = z.sum(axis=1) + c.sum(axis=1)
        return (e_k + 1.0).astype(base.dtype) * base[:, None, None] * jnp.ones((1, 4, 3))

    jfns = [lambda z, c, e=e: (e + 1.0) * (z.sum(axis=1) + c.sum(axis=1))[:, None, None]
            * jnp.ones((1, 4, 3)) for e in range(3)]
    ref = jax_decode(jfns, jnp.asarray(idx), jnp.asarray(cond), jnp.asarray(noise), (4, 3),
                     tile=8, in_scan_scatter=True, decode_dyn=jdyn)
    out = tiled_switch_decode(_decoders(3, (4, 3)), torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (4, 3), tile=8, decode_dyn=_dyn((4, 3)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_switch_decode_dyn_is_called():
    """A decode_dyn whose outputs differ from the branches changes the result
    (the argument is wired in)."""
    b = 16
    idx = torch.as_tensor([0, 1] * 8)
    marker = lambda e_k, z, c: torch.full((z.shape[0], 2, 2), -123.0)  # noqa: E731
    got = tiled_switch_decode(_decoders(2, (2, 2)), idx, torch.ones((b, 9)), torch.ones((b, 10)),
                              (2, 2), tile=4, decode_dyn=marker)
    assert torch.equal(got, torch.full((b, 2, 2), -123.0))


def test_switch_decode_dyn_empty_experts_decode_every_chunk():
    """Empty experts: the same result, and every one of the K = B/T + E chunks
    decoded (the launch sequence does not depend on the routing)."""
    b = 16
    idx = np.asarray([0, 4] * 8)  # experts 1..3 empty
    _, cond, noise = _inputs(5, b, 5)
    calls = []
    out = tiled_switch_decode(_decoders(5, (2, 2)), torch.from_numpy(idx),
                              torch.from_numpy(cond), torch.from_numpy(noise), (2, 2), tile=4,
                              decode_dyn=_dyn((2, 2), calls))
    np.testing.assert_allclose(out.numpy(), _reference(idx, cond, noise, (2, 2)),
                               rtol=1e-5, atol=1e-5)
    assert calls == [4] * (b // 4 + 5)


def test_switch_decode_dyn_all_one_expert():
    b = 16
    idx = np.full(b, 2)
    cond, noise = np.ones((b, 9), np.float32), np.ones((b, 10), np.float32)
    out = tiled_switch_decode(_decoders(4, (2, 2)), torch.from_numpy(idx), torch.from_numpy(cond),
                              torch.from_numpy(noise), (2, 2), tile=4, decode_dyn=_dyn((2, 2)))
    np.testing.assert_allclose(out.numpy(), _reference(idx, cond, noise, (2, 2)), rtol=1e-5)


def test_switch_decode_dyn_reads_nothing_to_the_host(monkeypatch):
    """The dyn form never reads a device value to the host (no ``bincount``,
    ``tolist``, ``item`` or truth test of a tensor), so a CUDA graph can hold
    it; the per-expert form does read the chunk table."""
    idx, cond, noise = _inputs(14, 16, 3)
    args = (torch.from_numpy(idx), torch.from_numpy(cond), torch.from_numpy(noise), (2, 2))
    ref = tiled_switch_decode(_decoders(3, (2, 2)), *args, tile=4)

    def refuse(*a, **k):
        raise AssertionError("host read")

    monkeypatch.setattr(torch, "bincount", refuse)
    for name in ("tolist", "item", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = tiled_switch_decode(_decoders(3, (2, 2)), *args, tile=4, decode_dyn=_dyn((2, 2)))
    with pytest.raises(AssertionError, match="host read"):
        tiled_switch_decode(_decoders(3, (2, 2)), *args, tile=4)
    monkeypatch.undo()
    assert torch.equal(out, ref)
