"""The port's numpy data path (``zdcsim_torch.data``) against the JAX
package's, on the CPU: the scalers, the synthetic events, and the fidelity
gate's train/test split, with the JAX package's host C++ library and
without it (its numpy fallbacks). The port has the numpy versions alone.
The gate's real channel sums and real-vs-real floor are checked here too,
on the same split, so that it is built once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidelity_torch as ft
from zdcsim_torch.config import load_config
from zdcsim_torch.data import scalers
from zdcsim_torch.data.dataset import get_train_test_data
from zdcsim_torch.data.synthetic import make_synthetic_dataset

FLOOR = 457.4265  # the JAX package's real-vs-real floor of this split
SPLIT_KEYS = ("test_indices", "x_test", "y_test", "x_train", "y_train")


@pytest.fixture(scope="module")
def split():
    return get_train_test_data(load_config(list(ft.GATE_OVERRIDES)))


@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler"])
def test_scalers_equal_jax(name):
    from zdcsim.data import scalers as jscalers

    rng = np.random.default_rng(1)
    x = rng.normal(3.0, 2.0, (50, 4)).astype(np.float32)
    x[:, 2] = 7.0  # a constant column maps to scale 1
    ours, ref = getattr(scalers, name)().fit(x), getattr(jscalers, name)().fit(x)
    for attr in vars(ref):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    y = ours.transform(x)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, ref.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(y), ref.inverse_transform(y))


def test_synthetic_dataset_equals_jax():
    from zdcsim.data.synthetic import make_synthetic_dataset as jax_make

    ours, ref = make_synthetic_dataset(400, (56, 30), seed=3), jax_make(400, (56, 30), seed=3)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.positions, ref.positions)
    assert sorted(ours.cond) == sorted(ref.cond)
    for k in ours.cond:
        if k == "std_proton":
            # Welford in the JAX package's C++ against two-pass float64 here
            np.testing.assert_allclose(ours.cond[k], ref.cond[k], rtol=0, atol=1e-5)
        else:
            assert ours.cond[k].dtype == ref.cond[k].dtype, k
            np.testing.assert_array_equal(ours.cond[k], ref.cond[k], err_msg=k)
    np.testing.assert_array_equal(ours.cond_matrix(), ref.cond_matrix())


@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_numpy"])
def test_gate_split_equals_jax(split, native, monkeypatch):
    """``get_train_test_data`` at the gate's overrides (fidelity.py:202-206):
    25600 synthetic events, seed 7."""
    from zdcsim import native as jnative
    from zdcsim.config import load_config as jax_load_config
    from zdcsim.data import get_train_test_data as jax_split

    if native:
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", True)
    ref = jax_split(jax_load_config(overrides=list(ft.GATE_OVERRIDES)))
    for k in SPLIT_KEYS:
        a, b = getattr(split, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert split.x_test.shape == (5120, 56, 30) and split.x_train.shape == (20480, 56, 30)
    np.testing.assert_array_equal(split.test_indices[:5], [11294, 2541, 15515, 25550, 22648])


def test_gate_real_channel_sums_and_floor(split):
    """The gate's real side: kernel E's plain version (a CPU tensor) against
    JAX's ``sum_channels(jnp.expm1(real))`` at rtol 1e-5, and the floor of
    the seeded halves at rtol 1e-4 of JAX's."""
    from zdcsim.data.loader import split_to_arrays as jax_arrays
    from zdcsim.ops.channels import sum_channels
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.ops.epilogue_kernels import expm1_channel_sums

    arrays = split_to_arrays(split, False)
    for k, v in jax_arrays(split, False).items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    real = arrays["real"][..., 0]
    ch_real = expm1_channel_sums(torch.from_numpy(real))
    ref = np.asarray(sum_channels(jnp.expm1(jnp.asarray(real))))
    np.testing.assert_allclose(ch_real.numpy(), ref, rtol=1e-5)
    floor, perm = ft.real_floor(ch_real)
    np.testing.assert_array_equal(perm.numpy(), np.random.default_rng(0).permutation(5120))
    np.testing.assert_allclose(floor, FLOOR, rtol=1e-4)
    np.testing.assert_allclose(float(ch_real.mean()), 6868.839, rtol=1e-4)


def test_split_refuses_what_is_not_ported():
    """The default config reads the reference's pickles, absent here: the
    read raises naming the file, as JAX's ``pd.read_pickle`` does (reading
    them: tests/test_torch_pickles.py); a resume whose run saved no split
    raises rather than draw a new one (saving and resuming:
    tests/test_torch_loop.py)."""
    with pytest.raises(FileNotFoundError, match="data_proton_photonsum_proton_1_2312.pkl"):
        get_train_test_data(load_config())
    cfg = load_config(["dataset.synthetic=true", "dataset.synthetic_n_samples=32",
                       "train.checkpoint_experiment_dir=/nonexistent/run", "train.epoch_to_load=3"])
    with pytest.raises(FileNotFoundError, match="train_test_indices"):
        get_train_test_data(cfg)
