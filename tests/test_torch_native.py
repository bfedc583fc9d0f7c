"""The port's host C++ library (``zdcsim_torch.native``) against numpy and
against the JAX package's own (``zdcsim.native``), on the CPU.

Photon sums of photon counts, argmax coordinates (ties included) and the
row gather are equal to numpy's and to ``zdcsim.native``'s; ``log1p`` is
equal to ``zdcsim.native``'s and within two ulp of numpy's (numpy's float32
``log1p`` is its own SIMD routine, not the C library's ``log1pf`` that both
C++ libraries call, so neither library equals it bit for bit); the group
standard deviation (Welford in double) is within 1e-5 of numpy's two-pass
float64 and within 1e-6 of ``zdcsim.native``'s. The library builds into
``zdcsim_torch/_build/`` under a source-hash name. Without g++ the numpy
versions run, with one logged warning. The prep command line's report is
byte-equal to JAX's with the library and without it.
"""

import logging
import os

import numpy as np
import pytest

from zdcsim import native as jax_native
from zdcsim_torch import native
from zdcsim_torch.native import build

SHAPE = (56, 30)


@pytest.fixture
def numpy_only(monkeypatch, tmp_path):
    """The port's library unbuilt, with no g++ on PATH: its loader retries."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native


def images(seed, n=512, counts=True):
    rng = np.random.default_rng(seed)
    if counts:  # photon counts, some events empty, as the raw showers
        return (rng.poisson(2.0, (n, *SHAPE)) * rng.integers(0, 3, (n, 1, 1))).astype(np.float32)
    return rng.standard_normal((n, *SHAPE), dtype=np.float32)


def test_library_builds_into_the_build_dir():
    assert native.available() and jax_native.available()
    path = build.lib_path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(os.path.dirname(
        native.__file__)), "_build")
    assert os.path.basename(path).startswith("libzdcsim_prep_") and os.path.exists(path)
    src_dir = os.path.dirname(build.SOURCE)
    assert not [f for d in (src_dir, os.path.dirname(src_dir)) for f in os.listdir(d)
                if f.endswith(".so")]


@pytest.mark.parametrize("seed", [0, 1])
def test_sums_coordinates_log1p_gather_exact(seed):
    assert native.available()
    x = images(seed)
    n = x.shape[0]
    sums = native.photon_sums(x)
    np.testing.assert_array_equal(sums, x.reshape(n, -1).sum(axis=1))
    np.testing.assert_array_equal(sums, jax_native.photon_sums(x))

    for y in (x, images(seed + 10, counts=False)):  # counts tie often, normals rarely
        flat = y.reshape(n, -1).argmax(axis=1)
        ref = np.stack([flat // SHAPE[1], flat % SHAPE[1]], axis=1).astype(np.float32)
        np.testing.assert_array_equal(native.max_coords(y), ref)
        np.testing.assert_array_equal(native.max_coords(y), jax_native.max_coords(y))

    lin = np.abs(images(seed + 20, counts=False)) * 40
    ours = native.log1p_(lin.copy())
    np.testing.assert_array_equal(ours, jax_native.log1p_(lin.copy()))
    np.testing.assert_array_max_ulp(ours, np.log1p(lin), maxulp=2)
    buf = lin.copy()
    assert native.log1p_(buf) is buf  # in place

    idx = np.random.default_rng(seed).integers(0, n, 777)
    np.testing.assert_array_equal(native.gather_rows(x, idx), x[idx])
    np.testing.assert_array_equal(native.gather_rows(x, idx), jax_native.gather_rows(x, idx))


def test_group_std_against_numpy_and_jax():
    assert native.available()
    x = np.log1p(images(2))
    n = x.shape[0]
    group_ids = np.random.default_rng(3).integers(0, 120, n)  # groups of 0-12, singletons too
    ours = native.group_pixel_std(x, group_ids)
    ref = np.zeros(n)
    flat = x.reshape(n, -1).astype(np.float64)
    for g in np.unique(group_ids):  # numpy's two-pass float64 std
        sel = np.flatnonzero(group_ids == g)
        if sel.size > 1:
            ref[sel] = flat[sel].std(axis=0).sum()
    singletons = np.bincount(group_ids)[group_ids] == 1
    assert singletons.any() and (ours[singletons] == 0).all()
    np.testing.assert_allclose(ours, ref.astype(np.float32), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, jax_native.group_pixel_std(x, group_ids), rtol=0, atol=1e-6)


def test_numpy_versions_without_gxx(numpy_only, caplog):
    x = images(4)
    idx = np.arange(x.shape[0])[::-3]
    with caplog.at_level(logging.WARNING, logger="zdcsim_torch.native"):
        sums = numpy_only.photon_sums(x)
        assert not numpy_only.available()
    warnings = [r for r in caplog.records if "host library unavailable" in r.getMessage()]
    assert len(warnings) == 1 and "g++ not found" in warnings[0].getMessage()
    assert not os.path.exists(build.BUILD_DIR)
    np.testing.assert_array_equal(sums, x.reshape(x.shape[0], -1).sum(axis=1))
    np.testing.assert_array_equal(numpy_only.max_coords(x), jax_native.max_coords(x))
    np.testing.assert_array_equal(numpy_only.gather_rows(x, idx), x[idx])
    lin = np.abs(images(5, counts=False))
    np.testing.assert_array_equal(numpy_only.log1p_(lin.copy()), np.log1p(lin))


@pytest.mark.parametrize("with_library", [True, False], ids=["library", "numpy"])
def test_prep_report_byte_equal_to_jax(tmp_path, monkeypatch, with_library):
    """``python -m zdcsim_torch.data.prep --report`` in-process, beside JAX's
    (the raw pickles of ``tests/test_torch_prep_cli.py``)."""
    pytest.importorskip("pandas")
    from test_torch_prep_cli import argv, raw_inputs

    from zdcsim.data import prep as jax_prep
    from zdcsim_torch.data import prep

    if not with_library:
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
        monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
    raw_inputs(tmp_path, "proton", seed=2)
    jax_prep.main(argv(tmp_path, "jax", "proton"))
    prep.main(argv(tmp_path, "port", "proton"))
    assert native.available() == with_library
    ref, ours = ((tmp_path / d / "analysis_report.txt").read_bytes() for d in ("jax", "port"))
    assert ours == ref
