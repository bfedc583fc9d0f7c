"""The port's plain int8 conv (``zdcsim_torch.models.proton_fast._conv_i8``)
sums int8 products in int32, as the JAX ``_conv_i8`` does: bit-equal to it
and to an int64 direct sum. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zdcsim.models.proton_fast as J
import zdcsim_torch.models.proton_fast as T

# (B, H, W, Cin, Cout, kh, kw, pad): teacher Conv_1 on the resized grid and
# Conv_2, a Conv_0 phase, and the Cin=32 student Conv_1.
SHAPES = [
    (2, 56, 30, 256, 128, 4, 4, ((1, 1), (1, 1))),
    (2, 55, 29, 128, 64, 3, 3, ((1, 1), (1, 1))),
    (1, 18, 10, 512, 256, 2, 3, ((0, 1), (1, 1))),
    (3, 56, 30, 32, 32, 4, 4, ((1, 1), (1, 1))),
]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _operands(rng, b, h, w, cin, cout, kh, kw):
    xq = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    kq = rng.integers(-127, 128, (kh, kw, cin, cout), dtype=np.int8)
    return xq, kq


def _direct_sum(xq, kq, pad):
    """int64 direct sum over the taps of a zero-padded NHWC input."""
    kh, kw = kq.shape[:2]
    xp = np.pad(xq.astype(np.int64), ((0, 0), pad[0], pad[1], (0, 0)))
    ho, wo = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    out = np.zeros((xq.shape[0], ho, wo, kq.shape[3]), np.int64)
    for a in range(kh):
        for c in range(kw):
            out += xp[:, a:a + ho, c:c + wo] @ kq[a, c].astype(np.int64)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:7])))
def test_conv_i8_bit_equal_to_jax_int32(shape):
    b, h, w, cin, cout, kh, kw, pad = shape
    xq, kq = _operands(np.random.default_rng(cin + cout), b, h, w, cin, cout, kh, kw)
    ref = np.asarray(J._conv_i8(jnp.asarray(xq), jnp.asarray(kq), pad))
    out = T._conv_i8(torch.from_numpy(xq), torch.from_numpy(kq), pad)
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["conv1", "conv2"])
def test_conv_i8_equals_int64_direct_sum_at_extreme_values(shape):
    """Operands at +-127 with 1% of the signs flipped: near the largest sums
    the decode can produce, where a float32 sum would round
    (|sum| above 2**24)."""
    b, h, w, cin, cout, kh, kw, pad = shape
    rng = np.random.default_rng(5)
    xq = np.where(rng.random((b, h, w, cin)) < 0.01, -127, 127).astype(np.int8)
    kq = np.where(rng.random((kh, kw, cin, cout)) < 0.01, -127, 127).astype(np.int8)
    out = T._conv_i8(torch.from_numpy(xq), torch.from_numpy(kq), pad).numpy()
    ref = _direct_sum(xq, kq, pad)
    assert np.abs(ref).max() > 2 ** 24
    np.testing.assert_array_equal(out.astype(np.int64), ref)


def test_conv_i8_strided_matches_int64_direct_sum():
    """The row-strided form that the folded row-resize int8 conv uses."""
    rng = np.random.default_rng(9)
    xq, kq = _operands(rng, 2, 36, 30, 16, 8, 3, 4)
    out = T._conv_i8(torch.from_numpy(xq), torch.from_numpy(kq), ((0, 0), (1, 1)), (5, 1))
    ref = _direct_sum(xq, kq, ((0, 0), (1, 1)))[:, ::5]
    np.testing.assert_array_equal(out.numpy().astype(np.int64), ref)


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 2, 2, 8, 8), (2, 6, 5, 12, 8), (2, 6, 5, 8, 4)],
                         ids=["16-rows", "cin-12", "cout-4"])
def test_conv_i8_raises_on_shapes_int_mm_refuses(b, h, w, cin, cout):
    """``torch._int_mm`` needs > 16 rows and Cin, Cout multiples of 8: the
    conv raises on the CPU as on the card, and never takes a float path."""
    xq, kq = _operands(np.random.default_rng(0), b, h, w, cin, cout, 3, 3)
    with pytest.raises(ValueError, match="_int_mm"):
        T._conv_i8(torch.from_numpy(xq), torch.from_numpy(kq), ((1, 1), (1, 1)))
