"""The port's offline prep command line (``python -m zdcsim_torch.data.prep``),
its writer, the dataset report and ``image_feature_stats`` against the JAX
package's, on the CPU.

JAX's ``zdcsim.data.prep.main`` and the port's run on the same raw pickles
written here (proton and neutron, with a photon-sum filter that drops
events, and condition groups of several events); their three output
pickles are equal through ``pd.read_pickle`` and their
``analysis_report.txt`` is byte-equal. The port's writer raises, naming
pandas, where pandas cannot be imported, and writes nothing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from zdcsim.data import prep as jax_prep  # noqa: E402
from zdcsim.evals.report import dataset_analysis_report as jax_report  # noqa: E402
from zdcsim.evals.stats import image_feature_stats as jax_stats  # noqa: E402
from zdcsim_torch.data import prep  # noqa: E402
from zdcsim_torch.evals.report import dataset_analysis_report  # noqa: E402
from zdcsim_torch.evals.stats import image_feature_stats  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"proton": (56, 30), "neutron": (44, 44)}


def raw_inputs(tmp_path, zdc, seed=0, n=36):
    """Linear-space photon counts (some events empty) and a conditioning
    frame whose rows repeat in groups of three."""
    rng = np.random.default_rng(seed)
    imgs = (rng.poisson(0.4, (n, *SHAPES[zdc])) * rng.integers(0, 3, (n, 1, 1))).astype(
        np.float32)
    cond = pd.DataFrame({c: np.repeat(rng.standard_normal(n // 3), 3)
                         for c in prep.COND_COLUMNS})
    cond["unused"] = np.arange(n)
    pd.to_pickle(imgs, tmp_path / "raw_images.pkl")
    pd.to_pickle(cond, tmp_path / "raw_cond.pkl")
    return imgs


def argv(tmp_path, out, zdc):
    os.makedirs(tmp_path / out, exist_ok=True)
    return ["--raw-images", str(tmp_path / "raw_images.pkl"),
            "--raw-cond", str(tmp_path / "raw_cond.pkl"), "--zdc-type", zdc,
            "--min-photon-sum", "1", "--out-images", str(tmp_path / out / "images.pkl"),
            "--out-cond", str(tmp_path / out / "cond.pkl"),
            "--out-positions", str(tmp_path / out / "positions.pkl"), "--report"]


@pytest.mark.parametrize("zdc", ["proton", "neutron"])
def test_prep_cli_writes_what_jax_writes(tmp_path, zdc):
    raw_inputs(tmp_path, zdc)
    jax_prep.main(argv(tmp_path, "jax", zdc))
    prep.main(argv(tmp_path, "port", zdc))
    ref_img, img = (pd.read_pickle(tmp_path / d / "images.pkl") for d in ("jax", "port"))
    assert img.dtype == ref_img.dtype
    np.testing.assert_array_equal(img, ref_img)
    for name in ("cond.pkl", "positions.pkl"):
        ref, ours = (pd.read_pickle(tmp_path / d / name) for d in ("jax", "port"))
        pd.testing.assert_frame_equal(ours, ref, check_exact=True)
    ref_txt, txt = ((tmp_path / d / "analysis_report.txt").read_bytes() for d in ("jax", "port"))
    assert txt == ref_txt
    assert b"Reducing the data from: 36 to" in txt


def test_prep_module_runs_as_a_script(tmp_path):
    raw_inputs(tmp_path, "proton", seed=1)
    proc = subprocess.run([sys.executable, "-m", "zdcsim_torch.data.prep",
                           *argv(tmp_path, "out", "proton")], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "Analysis report written to" in proc.stderr
    cond = pd.read_pickle(tmp_path / "out" / "cond.pkl")
    assert list(cond.columns) == [*prep.COND_COLUMNS, "proton_photon_sum", "std_proton",
                                  "group_number_proton", "expert_number"]


def test_writer_raises_without_pandas(tmp_path, monkeypatch):
    raw_inputs(tmp_path, "proton", seed=2)
    monkeypatch.setitem(sys.modules, "pandas", None)  # `import pandas` now raises
    with pytest.raises(ImportError, match="pandas"):
        prep.main(argv(tmp_path, "out", "proton"))  # reads the raw pickles, then the writer
    assert not os.listdir(tmp_path / "out")


def showers(seed=3, n=20, shape=(56, 30)):
    rng = np.random.default_rng(seed)
    imgs = rng.exponential(2.0, (n, *shape)) * (rng.random((n, *shape)) < 0.3)
    imgs[0] = 0.0  # an empty shower: centres of mass on a zero total
    return imgs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_image_feature_stats_equals_jax(dtype):
    imgs = showers().astype(dtype)
    ours, ref = image_feature_stats(imgs), jax_stats(imgs)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("with_sums", [False, True])
def test_report_equals_jax(with_sums):
    imgs = showers(seed=4, shape=(44, 44))
    kw = dict(photon_sums=imgs.reshape(len(imgs), -1).sum(1) * 1.5, n_before_filter=31,
              title="t") if with_sums else {}
    assert dataset_analysis_report(imgs, **kw) == jax_report(imgs, **kw)
