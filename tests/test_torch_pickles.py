"""The port's pandas-free reader of the reference's training pickles
(``zdcsim_torch.data.pickles``) and the split it feeds, on the CPU.

The reader against ``pd.read_pickle`` on the committed fixtures
(``tests/fixtures/real_pickles``: values, dtypes, column order) and on
frames written here (the pandas 2.x layout with an object column index,
which pandas 3 writes under ``future.infer_string=False``; pickle protocols
4 and 5), in a subprocess where pandas and pyarrow cannot be imported, and
its refusal of a global outside its allowlist. Then the port's
``get_dataset`` + ``transform_data_for_training`` on the fixtures against
``expected.npz`` and against the JAX package's own functions at rtol / atol
1e-6, with and without ``limit_samples``; and ``chip_smoke.py`` phase 22
rehearsed where pandas, pyarrow and matplotlib cannot be imported.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from zdcsim.config import load_config as jax_load_config  # noqa: E402
from zdcsim.data.dataset import get_dataset as jax_get_dataset  # noqa: E402
from zdcsim.data.dataset import transform_data_for_training as jax_transform  # noqa: E402
from zdcsim_torch.config import load_config  # noqa: E402
from zdcsim_torch.data.dataset import get_dataset, transform_data_for_training  # noqa: E402
from zdcsim_torch.data.pickles import read_pickle  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "real_pickles")
FILES = ("data_proton_fixture.pkl", "data_cond_fixture.pkl", "data_coord_fixture.pkl")
SPLIT_KEYS = ("x_train", "x_test", "x_train_2", "x_test_2", "y_train", "y_test", "std_train",
              "std_test", "intensity_train", "intensity_test", "positions_train",
              "positions_test", "expert_number_train", "expert_number_test", "train_indices",
              "test_indices")


def assert_same_as_pandas(path):
    ours, ref = read_pickle(path), pd.read_pickle(path)
    if isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
        return
    assert list(ours) == list(ref.columns)
    for col in ref.columns:
        want = ref[col].to_numpy()
        assert ours[col].dtype == want.dtype, col
        np.testing.assert_array_equal(ours[col], want, err_msg=col)


@pytest.mark.parametrize("name", FILES)
def test_reader_equals_pandas_on_the_fixtures(name):
    assert_same_as_pandas(os.path.join(FIX, name))


@pytest.mark.parametrize("protocol", [4, 5])
def test_reader_reads_the_pandas_2x_layout(tmp_path, protocol):
    """An object-dtype column index (``numpy.ndarray`` through
    ``_reconstruct``) and columns of mixed dtypes in more than one block."""
    rng = np.random.default_rng(0)
    with pd.option_context("future.infer_string", False):
        df = pd.DataFrame({"Energy": rng.standard_normal(7), "max_x": np.arange(7.0),
                           "group_number_proton": np.arange(7, dtype=np.int64),
                           "std_proton": rng.standard_normal(7).astype(np.float32)})
        assert df.columns.dtype == object
        path = tmp_path / "frame.pkl"
        df.to_pickle(path, protocol=protocol)
        images = tmp_path / "images.pkl"
        pd.to_pickle(rng.standard_normal((3, 4, 5)).astype(np.float32), images,
                     protocol=protocol)
    names = {a for op, a, _ in __import__("pickletools").genops(path.read_bytes())
             if isinstance(a, str)}
    assert "_reconstruct" in names and "ArrowStringArray" not in names
    assert_same_as_pandas(path)
    assert_same_as_pandas(images)


def test_reader_reads_the_setstate_layout(tmp_path):
    """pandas before 2.1 pickled a DataFrame's BlockManager as its
    ``__getstate__``, ``(axes, values, items, {"0.14.1": {axes, blocks}})``,
    rebuilt through ``__setstate__``; pandas 3 still reads it."""
    import copyreg

    from pandas.core.internals.managers import BlockManager

    def old_state(m):
        axes = list(m.axes)
        blocks = [{"values": b.values, "mgr_locs": b.mgr_locs.indexer} for b in m.blocks]
        return (axes, [b.values for b in m.blocks],
                [m.items[b.mgr_locs.indexer] for b in m.blocks],
                {"0.14.1": {"axes": axes, "blocks": blocks}})

    class OldPickler(pickle.Pickler):
        def reducer_override(self, obj):
            if type(obj) is BlockManager:
                return copyreg.__newobj__, (BlockManager,), old_state(obj)
            return NotImplemented

    with pd.option_context("future.infer_string", False):
        df = pd.DataFrame({"max_x": np.arange(5.0), "n": np.arange(5, dtype=np.int64),
                           "max_y": np.arange(5.0) * 2})
        path = tmp_path / "old.pkl"
        with open(path, "wb") as f:
            OldPickler(f, protocol=4).dump(df)
    assert b"0.14.1" in path.read_bytes() and b"_unpickle_block" not in path.read_bytes()
    assert_same_as_pandas(path)


def test_reader_maps_numpy_1x_module_names(tmp_path):
    """A file written under numpy 1.x names ``numpy.core.*``."""
    path = tmp_path / "images.pkl"
    pd.to_pickle(np.arange(12, dtype=np.float32).reshape(3, 4), path)
    raw = path.read_bytes()
    # keep the frame length valid: the SHORT_BINUNICODE length byte is rewritten too
    old, new = b"\x13numpy._core.numeric", b"\x12numpy.core.numeric"
    assert old in raw
    path.write_bytes(raw.replace(b"\x95" + raw[3:11], b"\x95" + (int.from_bytes(
        raw[3:11], "little") - 1).to_bytes(8, "little"), 1).replace(old, new))
    np.testing.assert_array_equal(read_pickle(str(path)), np.arange(12).reshape(3, 4))


def test_reader_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(b"cos\nsystem\n(S'echo refused'\ntR.")
    with pytest.raises(pickle.UnpicklingError, match=r"os\.system") as err:
        read_pickle(str(path))
    assert str(path) in str(err.value)


_BLOCK = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "pyarrow"):
            raise ImportError(f"import of {name!r} refused")
        return None
sys.meta_path.insert(0, Refuse())
"""


def test_reader_needs_neither_pandas_nor_pyarrow():
    code = _BLOCK + f"""
import numpy as np
from zdcsim_torch.data.pickles import read_pickle
imgs = read_pickle({os.path.join(FIX, FILES[0])!r})
cond = read_pickle({os.path.join(FIX, FILES[1])!r})
pos = read_pickle({os.path.join(FIX, FILES[2])!r})
assert not {{m.split(".")[0] for m in sys.modules}} & {{"pandas", "pyarrow"}}
np.savez(sys.argv[1], imgs=imgs, **{{"cond_" + k: v for k, v in cond.items()}},
         **{{"pos_" + k: v for k, v in pos.items()}})
print(",".join(cond))
"""
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"pickles_{os.getpid()}.npz")
    try:
        proc = subprocess.run([sys.executable, "-c", code, out], cwd=REPO, capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        got = np.load(out)
        ref_cond = pd.read_pickle(os.path.join(FIX, FILES[1]))
        assert proc.stdout.strip().split(",") == list(ref_cond.columns)
        np.testing.assert_array_equal(got["imgs"], pd.read_pickle(os.path.join(FIX, FILES[0])))
        for c in ref_cond.columns:
            np.testing.assert_array_equal(got["cond_" + c], ref_cond[c].to_numpy())
        for c in ("max_x", "max_y"):
            np.testing.assert_array_equal(got["pos_" + c],
                                          pd.read_pickle(os.path.join(FIX, FILES[2]))[c])
    finally:
        if os.path.exists(out):
            os.remove(out)


def fixture_overrides(**over):
    return [f"dataset.DATA_IMAGES_PATH={os.path.join(FIX, FILES[0])}",
            f"dataset.DATA_COND_PATH={os.path.join(FIX, FILES[1])}",
            f"dataset.DATA_POSITIONS_PATH={os.path.join(FIX, FILES[2])}",
            "train.save_experiment_data=false", "train.seed=7",
            *[f"{k}={v}" for k, v in over.items()]]


def test_split_equals_expected_npz():
    cfg = load_config(fixture_overrides())
    assert cfg.dataset.synthetic is False  # the default configuration's reader
    exp = np.load(os.path.join(FIX, "expected.npz"))
    ds = get_dataset(cfg)
    assert ds.n_events == int(exp["n_events"]) == 22
    np.testing.assert_allclose(cfg.photon_sum_min, exp["photon_sum_min"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cfg.photon_sum_max, exp["photon_sum_max"], rtol=1e-6, atol=1e-6)
    split = transform_data_for_training(cfg, ds)
    for key in SPLIT_KEYS:
        if key in exp:
            np.testing.assert_allclose(getattr(split, key), exp[key], rtol=1e-6, atol=1e-6,
                                       err_msg=key)
    np.testing.assert_allclose(split.scaler_cond.mean_, exp["scaler_cond_mean"], rtol=1e-6)
    np.testing.assert_allclose(split.scaler_cond.scale_, exp["scaler_cond_scale"], rtol=1e-6)


@pytest.mark.parametrize("limit", [None, 10, 17])
def test_split_equals_jax(limit):
    over = {} if limit is None else {"limit_samples": limit}
    jcfg = jax_load_config(overrides=fixture_overrides(**over))
    jds = jax_get_dataset(jcfg)
    ref = jax_transform(jcfg, jds)
    cfg = load_config(fixture_overrides(**over))
    ds = get_dataset(cfg)
    assert ds.n_events == jds.n_events
    assert (cfg.photon_sum_min, cfg.photon_sum_max) == (jcfg.photon_sum_min,
                                                        jcfg.photon_sum_max)
    assert list(ds.cond) == list(jds.cond)
    for k in ds.cond:
        assert ds.cond[k].dtype == np.asarray(jds.cond[k]).dtype, k
    np.testing.assert_array_equal(ds.positions, jds.positions)
    split = transform_data_for_training(cfg, ds)
    for key in SPLIT_KEYS:
        np.testing.assert_allclose(getattr(split, key), getattr(ref, key), rtol=1e-6,
                                   atol=1e-6, err_msg=key)


def test_chip_smoke_phase_22_rehearses_without_pandas_or_matplotlib():
    """``chip_smoke.py`` phase 22 on the CPU where pandas, pyarrow and
    matplotlib cannot be imported, as on the card's machine: the fixtures
    read and split as ``expected.npz``, ``cli_torch.py`` trained on them and
    resumed with the saved split, the figures refused before a step."""
    code = _BLOCK.replace('("pandas", "pyarrow")', '("pandas", "pyarrow", "matplotlib")') + """
import torch
import chip_smoke as cs
torch.set_num_threads(2)
print(cs.real_data(torch.device("cpu"), True, "cpu rehearsal", 0))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in ("equal to expected.npz at rtol/atol 1e-6: True",
                 "=== zdcsim proton dataset analysis (tests/fixtures/real_pickles) ===",
                 "exit 0 in", "the saved split read back True",
                 "without matplotlib raised before the first step",
                 "routing identical True", '{"real_data": '):
        assert line in proc.stdout, line
    assert proc.stdout.strip().splitlines()[-1] == "(0, 0)"  # no card: E's plain version
