"""``zdcsim_torch.models.proton_fast.fast_generator_apply`` against the JAX
one on a narrow random generator (width 1/16: every channel count is 32),
in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.models.proton import Generator as JaxGenerator
from zdcsim.models.proton_fast import fast_generator_apply as jax_apply
from zdcsim_torch.convert import tree_to_torch
from zdcsim_torch.models.proton_fast import fast_generator_apply

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


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((B, 10), dtype=np.float32)
    cond = rng.standard_normal((B, 9), dtype=np.float32)
    params = JaxGenerator(width=1 / 16).init(
        {"params": jax.random.PRNGKey(0)}, noise, cond, False)["params"]
    return jax.tree_util.tree_map(np.array, params), noise, cond


@pytest.mark.parametrize("int8", [False, True])
def test_fast_generator_xla_backend_matches_jax(tiny, int8):
    params, noise, cond = tiny
    ref = np.asarray(jax_apply(params, jnp.asarray(noise), jnp.asarray(cond), int8=int8))
    out = fast_generator_apply(tree_to_torch(params), torch.from_numpy(noise),
                               torch.from_numpy(cond), int8=int8).numpy()
    assert out.shape == ref.shape == (B, 56, 30, 1)
    err = np.abs(out - ref).max()
    if not int8:  # float path: tests/test_proton_fast.py:33
        print(f"float max |port - jax| = {err} (bound 2e-3)")
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)
    else:
        # The int8 stages equal JAX's on equal inputs; float32 norm
        # statistics differ in the last bits, which flips a few activation
        # roundings that cascade: the int8 bound of test_pallas_decode.py:203.
        bound = 0.05 * np.abs(ref).max() + 0.05
        print(f"int8 xla max |port - jax| = {err} (int8 bound {bound})")
        assert err < bound


def test_int8_stages_match_jax():
    """On equal inputs the plain int8 stages give JAX's values: both sum the
    int8 products in int32."""
    import zdcsim.models.proton_fast as J
    import zdcsim_torch.models.proton_fast as T

    rng = np.random.default_rng(2)
    k4 = rng.standard_normal((4, 4, 32, 16), dtype=np.float32) * 0.1
    k3 = rng.standard_normal((3, 3, 32, 16), dtype=np.float32) * 0.1
    bias = rng.standard_normal(16, dtype=np.float32)
    x0 = rng.standard_normal((2, 18, 10, 32), dtype=np.float32)
    x1 = rng.standard_normal((2, 35, 19, 32), dtype=np.float32)
    x2 = rng.standard_normal((2, 55, 29, 32), dtype=np.float32)
    t = torch.from_numpy
    pairs = [
        (J.fused_upsample2_conv4_int8(x0, k4, bias),
         T.fused_upsample2_conv4_int8(t(x0), T.quant_conv0_phases(t(k4)), t(bias))),
        (J.resize_conv4_int8_naive(x1, k4, bias, 56, 30),
         T.resize_conv4_int8_naive(t(x1), T._quant_per_cout(t(k4)), t(bias), 56, 30)),
        (J.conv3x3_int8(x2, k3, bias), T.conv3x3_int8(t(x2), T._quant_per_cout(t(k3)), t(bias))),
        (J.fused_upsample2_conv4(x0, k4, bias), T.fused_upsample2_conv4(t(x0), t(k4), t(bias))),
    ]
    for ref, out in pairs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
