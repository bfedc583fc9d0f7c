"""The port's ``save_serving_artifact`` against ``zdcsim/utils/artifact.py:63``:
the same keys and arrays equal bit for bit on one tree, and each package's
loader reads the other's file."""

import os

import numpy as np
import pytest

from zdcsim.utils.artifact import INT8_MIN_SIZE as JAX_INT8_MIN_SIZE
from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim.utils.artifact import save_serving_artifact as jax_save
from zdcsim_torch.convert import from_jax_params, stats_from_jax
from zdcsim_torch.utils.artifact import (
    INT8_MIN_SIZE, _flatten, load_serving_artifact, save_serving_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = {"epoch": 3, "weights": "distilled-student", "width": 0.125, "source": "a test"}


def tree(seed=0, e=2):
    """A Flax-layout tree with leaves above and below ``INT8_MIN_SIZE``: a
    stacked Dense kernel and a stacked conv kernel that go int8, a 2-D
    router kernel that goes int8 (scale over its input axis), small kernels,
    biases, a norm scale, BatchNorm statistics and the attention router's
    queries; one row of a kernel exactly zero (its scale is ``1e-12``)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    gen = {"Dense_0": {"kernel": n(e, 19, 4096, s=0.05), "bias": n(e, 4096)},
           "Conv_0": {"kernel": n(e, 4, 4, 64, 128, s=0.1), "bias": n(e, 128)},
           "Conv_1": {"kernel": n(e, 3, 3, 8, 4), "bias": n(e, 4)},
           "LayerNorm_0": {"scale": n(e, 256) + 1, "bias": n(e, 256)}}
    gen["Conv_0"]["kernel"][1, ..., 7] = 0.0
    stats = {"batch_stats": {"MaskedBatchNorm_0": {"mean": n(e, 64), "var": n(e, 64) ** 2}}}
    router = {"Dense_0": {"kernel": n(9, 8192), "bias": n(8192)},
              "Dense_1": {"kernel": n(8192, 3, s=0.01), "bias": n(3)},
              "LayerNorm_0": {"scale": n(64), "bias": n(64)}, "expert_queries": n(3, 64)}
    return gen, stats, router


def test_int8_threshold_is_jax_s():
    assert INT8_MIN_SIZE == JAX_INT8_MIN_SIZE


@pytest.mark.parametrize("with_stats", [True, False])
def test_written_arrays_equal_jax_s(tmp_path, with_stats):
    gp, gs, rp = tree()
    gs = gs if with_stats else {}
    theirs = jax_save(str(tmp_path / "jax.npz"), gp, gs, rp, meta=META)
    gen, router = from_jax_params(gp, rp)
    ours = save_serving_artifact(str(tmp_path / "port.npz"), gen, stats_from_jax(gs), router,
                                 meta=META)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        int8 = [k for k in a.files if a[k].dtype == np.int8]
        assert sorted(int8) == ["gen_params|Conv_0|kernel", "gen_params|Dense_0|kernel",
                                "router_params|Dense_0|kernel"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
        assert a["gen_params|Conv_0|kernel::scale"].shape == (2, 1, 1, 1, 128)
        assert a["router_params|Dense_0|kernel::scale"].shape == (1, 8192)
    # JAX's loader reads the port's file as its own
    for x, y in zip(jax_load(ours), jax_load(theirs)):
        fx, fy = _flatten(x), _flatten(y)
        assert sorted(fx) == sorted(fy)
        for k in fx:
            assert np.array_equal(np.asarray(fx[k]), np.asarray(fy[k])), k
    assert jax_load(ours)[3] == {k: str(v) for k, v in META.items()}


def test_port_reads_back_what_it_wrote(tmp_path):
    """The port's loader on the port's file: within the codec's rounding of
    the source (int8: half a scale step, plus 127 steps of the scale's own
    float16 rounding, 2^-11 relative; float16 leaves: their rounding)."""
    gp, gs, rp = tree(1)
    gen, router = from_jax_params(gp, rp)
    path = save_serving_artifact(str(tmp_path / "a.npz"), gen, stats_from_jax(gs), router)
    g2, s2, r2, meta = load_serving_artifact(path)
    assert meta == {}
    for src, back in ((gp, g2), (gs, s2), (rp, r2)):
        fs, fb = _flatten(src), _flatten(back)
        assert sorted(fs) == sorted(fb)
        for k, v in fs.items():
            assert fb[k].dtype == np.float32 and fb[k].shape == v.shape, k
            if v.size >= INT8_MIN_SIZE and v.ndim >= 2:
                axes = tuple(range(0 if v.ndim == 2 else 1, v.ndim - 1))
                step = np.max(np.abs(v), axis=axes, keepdims=True) / 127.0
                assert np.all(np.abs(fb[k] - v) <= (0.5 + 127 * 2.0 ** -11) * step * 1.01 + 1e-7), k
            else:
                np.testing.assert_allclose(fb[k], v, rtol=1e-3, atol=1e-7, err_msg=k)


def test_committed_student_rewrites_as_jax(tmp_path):
    """A committed student artifact, loaded and written by the port, equals
    JAX's writer on the same loaded trees (the float16 leaves written back
    unchanged, the int8 ones requantised from their dequantised values)."""
    src = os.path.join(REPO, "artifacts", "gate", "neutron_student_w0.125_serving_weights.npz")
    gp, gs, rp, meta = load_serving_artifact(src)
    gen, router = from_jax_params(gp, rp)
    ours = save_serving_artifact(str(tmp_path / "port.npz"), gen, stats_from_jax(gs), router,
                                 meta=meta)
    theirs = jax_save(str(tmp_path / "jax.npz"), *jax_load(src)[:3], meta=meta)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
