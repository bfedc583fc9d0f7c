"""The port's 5-channel decomposition (``zdcsim_torch.ops.channels``) and
the plain versions of kernels E and F (``zdcsim_torch.ops.epilogue_kernels``)
against the JAX package, on the CPU. JAX runs its Pallas kernels E and F in
interpret mode; the port's wrappers run their plain versions for a CPU
tensor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.ops import channels as jch
from zdcsim.ops.pallas_kernels import expm1_channel_sums as jax_e
from zdcsim.ops.pallas_kernels import routed_expm1_channel_sums as jax_f
from zdcsim_torch.ops import channels as ch
from zdcsim_torch.ops import epilogue_kernels as ek


@pytest.mark.parametrize("shape", [(56, 30), (44, 44), (8, 6), (7, 5)])
def test_masks_and_basis_are_bit_identical(shape):
    ours, ref = ch.get_channel_masks(shape), jch.get_channel_masks(shape)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ch.channel_basis(shape), jch.channel_basis(shape))
    # the position rule kernels E and F compute instead of reading the masks
    h, w = shape
    r, c = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    chan = np.where((r + c) % 2 == 1, np.where(r >= h // 2, 0, 2) + np.where(c < w // 2, 0, 1), 4)
    np.testing.assert_array_equal(np.stack(ours).argmax(axis=0), chan)
    np.testing.assert_array_equal(np.stack(ours).sum(axis=0), np.ones(shape))


@pytest.mark.parametrize("shape", [(56, 30), (44, 44), (7, 5)])
def test_sum_channels_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random((6, *shape), dtype=np.float32) * 3
    ref = np.asarray(jch.sum_channels(jnp.asarray(x)))
    # tolerance of tests/test_pallas_kernels.py (float32 sums in another order)
    np.testing.assert_allclose(ch.sum_channels(torch.from_numpy(x)).numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(ch.sum_channels(torch.from_numpy(x[:, None])).numpy(), ref,
                               rtol=1e-5)
    np.testing.assert_allclose(ch.sum_channels_np(x), jch.sum_channels_np(x), rtol=1e-5)
    log_ref = np.asarray(jch.sum_channels(jnp.asarray(x), already_expm1=False))
    np.testing.assert_allclose(
        ch.sum_channels(torch.from_numpy(x), already_expm1=False).numpy(), log_ref, rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 6), (56, 30), (44, 44)])
def test_routed_epilogue_plain_matches_jax_kernel(shape):
    """Shapes of tests/test_pallas_kernels.py::test_routed_epilogue_matches_reference."""
    e, b = 3, 8
    rng = np.random.default_rng(shape[0])
    imgs = rng.random((e, b, *shape)).astype(np.float32)
    idx = rng.integers(0, e, b)
    ref = np.asarray(jax_f(jnp.asarray(imgs), jnp.asarray(idx, jnp.int32), interpret=True))
    out = ek.routed_expm1_channel_sums(torch.from_numpy(imgs), torch.from_numpy(idx))
    assert out.shape == (b, 5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype", [((10, 8, 6), torch.float32),
                                         ((5, 56, 30), torch.float32),
                                         ((5, 56, 30), torch.bfloat16)])
def test_plain_epilogue_plain_matches_jax_kernel(shape, dtype):
    """(10, 8, 6) is the shape of tests/test_pallas_kernels.py; bf16 input is
    cast to f32 in both kernels' bodies."""
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                               else jnp.float32)
    ref = np.asarray(jax_e(jx, interpret=True))
    out = ek.expm1_channel_sums(x)
    assert out.shape == (shape[0], 5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


def test_routed_plain_writes_nan_for_a_bad_id():
    imgs = torch.rand((3, 4, 8, 6))
    out = ek.routed_expm1_channel_sums(imgs, torch.tensor([0, -1, 2, 3]))
    assert torch.isnan(out[[1, 3]]).all() and torch.isfinite(out[[0, 2]]).all()
    torch.testing.assert_close(out[[0, 2]], ek.expm1_channel_sums(imgs[[0, 2], [0, 2]]))


def test_cpu_wrappers_count_no_launches():
    e0, f0 = ek.expm1_channel_sums.launches, ek.routed_expm1_channel_sums.launches
    ek.expm1_channel_sums(torch.rand((2, 8, 6)))
    ek.routed_expm1_channel_sums(torch.rand((3, 2, 8, 6)), torch.tensor([0, 2]))
    assert (ek.expm1_channel_sums.launches, ek.routed_expm1_channel_sums.launches) == (e0, f0)


@pytest.mark.parametrize("bad", [torch.rand((2, 3, 8, 6)), torch.rand((8, 6)),
                                 torch.rand((2, 8, 6), dtype=torch.float64),
                                 torch.ones((2, 8, 6), dtype=torch.int32)])
def test_e_refuses_bad_shapes_and_dtypes(bad):
    with pytest.raises(ValueError, match="expm1_channel_sums"):
        ek.expm1_channel_sums(bad)


@pytest.mark.parametrize("imgs,idx", [
    (torch.rand((2, 8, 6)), torch.tensor([0, 1])),  # not 4-D
    (torch.rand((3, 2, 8, 6), dtype=torch.float16), torch.tensor([0, 1])),
    (torch.rand((3, 2, 8, 6)), torch.tensor([0, 1], dtype=torch.int32)),
    (torch.rand((3, 2, 8, 6)), torch.tensor([0, 1, 2])),  # not [B]
])
def test_f_refuses_bad_shapes_and_dtypes(imgs, idx):
    with pytest.raises(ValueError, match="routed_expm1_channel_sums"):
        ek.routed_expm1_channel_sums(imgs, idx)
