"""``fidelity_torch.py`` on a run directory of the port's checkpoints
(``fidelity.py:110-138, 172-181, 225-234``): a run written by the port's
loop at width 0.125 (E=3, 40 synthetic events, 2 epochs) gates through
``run_gate`` and the CLI, on the split that the run saved and on a given
one; its latest epoch resolves as JAX's ``_resolve_latest_epoch``; ``raw``
and ``ema`` serve different trees; the record carries ``fidelity.py``'s
run-dir keys; a directory without checkpoints gives ``fidelity.py``'s
error, and one of another format names it."""

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch

import fidelity
import fidelity_torch as ft
from zdcsim_torch.config import load_config
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.train.loop import train
from zdcsim_torch.utils.io import DIR_MODELS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["model.generator.width=0.125", "dataset.synthetic_n_samples=40", "train.batch_size=16"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 2-epoch run of the gate's recipe at width 0.125 on 40 events, a
    checkpoint at each epoch."""
    root = tmp_path_factory.mktemp("runs")
    cfg = load_config([*ft.GATE_OVERRIDES, *RUN, "train.epochs=2", "train.eval_every=1",
                       "train.save_experiment_data=true", "train.ws_threshold_model_save=1e30",
                       "train.checkpoint_keep_best=0", f"train.save_experiments_dir={root}/",
                       "eval.chunk_size=8"])
    train(cfg, device="cpu")
    (path,) = glob.glob(os.path.join(str(root), "*"))
    return path


def fidelity_py_run_dir_keys():
    """The keys of ``fidelity.py``'s ``result`` literal, read from its source
    (its run-dir record adds ``warning`` under the calibration length)."""
    tree = ast.parse(open(fidelity.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            keys = {k.value for k in node.value.keys}
            if "checkpoint" in keys:
                return keys
    raise AssertionError("no result literal in fidelity.py")


def test_record_keys_are_fidelity_py_s():
    assert set(ft.RECORD_KEYS) == fidelity_py_run_dir_keys()


def test_latest_epoch_resolves_as_jax(run_dir):
    models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=run_dir)
    assert sorted(os.listdir(models)) == ["state_epoch_0", "state_epoch_1"]
    os.makedirs(os.path.join(models, "state_epoch_7.tmp"))  # neither reads this one
    try:
        assert ft._resolve_latest_epoch(run_dir) == fidelity._resolve_latest_epoch(run_dir) == 1
    finally:
        os.rmdir(os.path.join(models, "state_epoch_7.tmp"))
    assert ft._resolve_target(run_dir) == (None, run_dir)


def test_run_dir_gates_on_its_saved_split(run_dir, capsys):
    """The CLI on the run directory (latest epoch, EMA, ``int8``): the split
    that the run saved (8 test events), ``fidelity.py``'s keys, the warning."""
    assert ft.main([run_dir, "--device", "cpu", "--override", *RUN]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == fidelity_py_run_dir_keys() | {"warning", "device"}
    assert rec["checkpoint"] == f"{run_dir}@1" and rec["weights"] == "ema"
    assert rec["precision"] == "int8" and rec["n_test"] == 8
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["warning"].startswith("weights trained 2 epochs; the 1.5x criterion")


def test_raw_and_ema_serve_different_trees(run_dir):
    cfg = load_config([*ft.GATE_OVERRIDES, *RUN])
    dir_models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=run_dir)
    engines = {w: FastSim.from_checkpoint(cfg, dir_models, 0, use_ema=w == "ema",
                                          precision="f32", device="cpu")
               for w in ("ema", "raw")}
    kernels = [e._experts[0]["Conv_0"]["kernel"] for e in engines.values()]
    assert not torch.equal(*kernels)
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((16, 9)).astype(np.float32),
            np.log1p(rng.gamma(1.0, 3.0, (16, 56, 30))).astype(np.float32))
    recs = {w: ft.run_gate(run_dir, "f32", "cpu", data=data, n_draws=1, epoch=0, weights=w,
                           overrides=RUN) for w in ("ema", "raw")}
    assert recs["ema"]["weights"] == "ema" and recs["raw"]["weights"] == "raw"
    assert recs["raw"]["checkpoint"] == f"{run_dir}@0" and recs["raw"]["n_test"] == 16
    assert recs["ema"]["ws_mean"] != recs["raw"]["ws_mean"]


def test_run_dir_without_checkpoints_gives_jax_s_error(tmp_path, capsys):
    """No ``state_epoch_*``: ``fidelity.py``'s error record and exit 1; a
    checkpoint directory of another format (Orbax's) names it."""
    empty = tmp_path / "run"
    os.makedirs(DIR_MODELS.format(EXPERIMENT_DIR_NAME=str(empty)))
    assert ft.main([str(empty), "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"metric": "fastsim_fidelity", "value": None,
                   "error": f"no state_epoch_* checkpoints under {empty}"}
    orbax = os.path.join(DIR_MODELS.format(EXPERIMENT_DIR_NAME=str(empty)), "state_epoch_3")
    os.makedirs(os.path.join(orbax, "default"))
    open(os.path.join(orbax, "_CHECKPOINT_METADATA"), "w").close()
    with pytest.raises(FileNotFoundError, match="Orbax"):
        ft.run_gate(str(empty), device="cpu", data=(np.zeros((2, 9), np.float32),
                                                    np.zeros((2, 56, 30), np.float32)))
