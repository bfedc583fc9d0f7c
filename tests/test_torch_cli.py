"""The port's CLI twin (``cli_torch.py`` -> ``zdcsim_torch/cli.py``) on the
CPU, at width 0.125 on a small synthetic split: a 1-epoch train that saves
its split and a checkpoint, ``--eval --checkpoint-epoch 0`` from that run
(printing the keys of JAX's evaluator), a switch bf16 train resumed from
its checkpoint, ``--simulate`` (writing the arrays JAX's writes), the
refusals, and ``_inject_checkpoint_epoch``'s cases as
``tests/test_resume.py:58-94``.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = ["dataset.synthetic=true", "dataset.synthetic_n_samples=40", "train.batch_size=16",
        "model.generator.width=0.125", "model.n_experts=3"]


def cli(tmp_path, *args):
    """``python cli_torch.py *args`` from ``tmp_path`` at two threads."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "cli_torch.py"), *args],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 1-epoch train that saves its split and its epoch-0 checkpoint."""
    tmp = tmp_path_factory.mktemp("cli")
    proc = cli(tmp, "--cpu", "--override", *DATA, "train.epochs=1", "config.run_name=cli",
               "train.save_experiment_data=true", "train.ws_threshold_model_save=1e30",
               f"train.save_experiments_dir={tmp}/")
    (exp_dir,) = glob.glob(f"{tmp}/cli_*")
    return tmp, exp_dir, proc


def jax_evaluator_keys():
    from zdcsim.config import load_config
    from zdcsim.models.testing import build_tiny_moe
    from zdcsim.train.evaluate import build_evaluator
    from zdcsim.train.state import init_state

    cfg = load_config(overrides=["model.n_experts=3", "dataset.input_image_shape=[8, 6]"])
    mods = build_tiny_moe(cfg, (8, 6))
    arrays = {"real": jax.numpy.ones((16, 8, 6, 1)), "cond": jax.numpy.zeros((16, 9))}
    m = build_evaluator(mods, cfg, chunk_size=16)(
        init_state(mods, cfg, jax.random.PRNGKey(0)), arrays, epoch=0, key=jax.random.PRNGKey(0))
    return set(m)


def test_cli_trains_one_epoch(trained):
    _, exp_dir, proc = trained
    assert "Final epoch metrics" in proc.stderr
    assert "epoch 0 (" in proc.stderr and "ws_mean=" in proc.stderr
    assert os.path.isfile(f"{exp_dir}/models/state_epoch_0/state.pt")
    assert os.path.isfile(f"{exp_dir}/info/train_test_indices.npz")
    assert os.path.isfile(f"{exp_dir}/info/proton_scales.txt")


def test_cli_evaluates_a_checkpoint(trained):
    tmp, exp_dir, _ = trained
    proc = cli(tmp, "--cpu", "--eval", "--checkpoint-epoch", "0", "--override", *DATA,
               f"train.checkpoint_experiment_dir={exp_dir}")
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(metrics) == jax_evaluator_keys()
    assert metrics["epoch"] == 0 and np.isfinite(metrics["ws_mean"])
    assert "Resumed" not in proc.stderr
    test_idx = np.load(f"{exp_dir}/info/train_test_indices.npz")["test_indices"]
    assert sum(metrics["eval_expert_counts"]) == len(test_idx)


def test_cli_trains_switch_bf16_and_resumes(tmp_path):
    """``train.dispatch=switch train.precision=bf16``: one epoch saving its
    checkpoint, then a run resumed from it; the loop's per-(epoch, batch)
    draws are the switch form's (one keep mask per row), or the step
    refuses them."""
    opts = [*DATA, "train.dispatch=switch", "train.dispatch_tile=4", "train.precision=bf16",
            "config.run_name=sw", "train.save_experiment_data=true",
            "train.ws_threshold_model_save=1e30", f"train.save_experiments_dir={tmp_path}/"]
    first = cli(tmp_path, "--cpu", "--override", *opts, "train.epochs=1")
    (exp_dir,) = glob.glob(f"{tmp_path}/sw_*")
    assert "epoch 0 (" in first.stderr and os.path.isfile(
        f"{exp_dir}/models/state_epoch_0/state.pt")
    again = cli(tmp_path, "--cpu", "--checkpoint-epoch", "0", "--override", *opts,
                "train.epochs=2", f"train.checkpoint_experiment_dir={exp_dir}")
    assert "Resumed from" in again.stderr
    assert "epoch 1 (" in again.stderr and "Final epoch metrics" in again.stderr


def test_cli_simulates(tmp_path):
    cli(tmp_path, "--cpu", "--simulate", "out.npz", "--override", *DATA)
    out = np.load(tmp_path / "out.npz")
    assert sorted(out.files) == ["experts", "showers"]  # JAX's np.savez keys
    n = len(out["experts"])
    assert out["showers"].shape == (n, 56, 30) and out["showers"].dtype == np.float32
    assert out["experts"].dtype == np.int32 and 0 < n < 40
    assert np.isfinite(out["showers"]).all() and out["showers"].min() >= 0


def test_cli_refusals(tmp_path):
    """A ``--config`` that selects the attention router loads and builds it
    (the CLI gets past its config to the device); CUDA unless ``--cpu``."""
    from zdcsim_torch.cli import main
    from zdcsim_torch.config import load_config
    from zdcsim_torch.models import build_moe

    path = tmp_path / "attention.yaml"
    path.write_text("model:\n  router:\n    version: router_attention\n")
    cfg = load_config(DATA, config_path=str(path))
    assert cfg.model.router.version == "router_attention"
    assert build_moe(cfg).names["router"] == "AttentionRouterNetwork"
    if not sys.modules["torch"].cuda.is_available():  # CUDA unless --cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", str(path), "--eval", "--override", *DATA])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--eval", "--override", *DATA])


def test_inject_checkpoint_epoch():
    from zdcsim.cli import _inject_checkpoint_epoch as jax_inject
    from zdcsim_torch.cli import _inject_checkpoint_epoch

    for overrides, epoch in ((["train.checkpoint_experiment_dir=/x"], 2), (["a=1"], None),
                             (["train.epoch_to_load=9"], 2)):
        assert _inject_checkpoint_epoch(overrides, epoch) == jax_inject(overrides, epoch)
    assert "train.epoch_to_load=2" in _inject_checkpoint_epoch(
        ["train.checkpoint_experiment_dir=/x"], 2)
    assert _inject_checkpoint_epoch(["a=1"], None) == ["a=1"]  # without the flag: untouched
    assert _inject_checkpoint_epoch(["train.epoch_to_load=9"], 2) == ["train.epoch_to_load=9"]
