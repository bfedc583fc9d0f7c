"""The port's training loop and its surroundings against the JAX package,
on the CPU: the config keys they read, ``_finalize_metrics``, the saved
split (``train.save_experiment_data`` and the resume path), checkpoints and
the checkpoint callback (``tests/test_evaluator.py:154-205``), and the loop
itself on the tiny modules, 3 epochs and then resumed from epoch 2 (as
``tests/test_resume.py``), with the history's keys equal to JAX's loop's.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from zdcsim.config import load_config as jax_load_config
from zdcsim_torch.config import load_config
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.state import init_state

SHAPE = (8, 6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run_overrides(tmp_path, **over):
    """tests/test_resume.py's run: 128 synthetic 8x6 events, batch 32, E=2,
    a checkpoint at every eval."""
    return ["dataset.synthetic=true", "dataset.synthetic_n_samples=128",
            "dataset.input_image_shape=[8, 6]", "train.batch_size=32", "model.n_experts=2",
            "train.eval_every=1", "train.ws_threshold_model_save=1e18",
            "train.save_experiment_data=true", f"train.save_experiments_dir={tmp_path}/",
            "parallel.n_devices=1", *[f"{k}={v}" for k, v in over.items()]]


def test_config_loop_keys_equal_jax_config():
    """The keys the loop, the evaluator, the callbacks and the CLI read have
    JAX's defaults (``zdcsim/config/default.yaml``)."""
    ours, ref = load_config(), jax_load_config()
    assert ours.config.run_name == ref.config.run_name
    for key in ("log_experiments", "plot_images"):
        assert getattr(ours.wandb, key) == ref.wandb[key], key
    for key in ("eval_every", "ws_threshold_model_save", "checkpoint_keep_best",
                "async_checkpointing", "save_experiments_dir", "save_eval_plots",
                "profile_epoch", "profile_dir"):
        assert getattr(ours.train, key) == ref.train[key], key
    for key in ("chunk_size", "bulk", "sample_routing", "fused_epilogue"):
        assert getattr(ours.eval, key) == ref.eval[key], key
    for key in ("n_devices", "expert_parallel"):
        assert getattr(ours.parallel, key) == ref.parallel[key], key
    with pytest.raises(ValueError, match="together"):
        load_config(["train.epoch_to_load=3"])


def test_finalize_metrics_equals_jax():
    from zdcsim.train.loop import _accumulate as jax_accumulate
    from zdcsim.train.loop import _finalize_metrics as jax_finalize
    from zdcsim_torch.train.loop import _accumulate, _finalize_metrics

    rng = np.random.default_rng(0)
    batches = [{"gen_loss": rng.standard_normal((), np.float32),
                "tau": np.float32(1.2),
                "gen_loss_experts": rng.standard_normal(3).astype(np.float32),
                "n_choosen_experts_mean_epoch": rng.random(3).astype(np.float32)}
               for _ in range(3)]
    acc = ref = None
    for b in batches:
        acc = _accumulate(acc, {k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        ref = jax_accumulate(ref, {k: jax.numpy.asarray(v) for k, v in b.items()})
    ours, theirs = _finalize_metrics(acc, 3), jax_finalize(ref, 3)
    assert ours == theirs
    assert set(ours) == {"gen_loss", "tau", "gen_loss_0", "gen_loss_1", "gen_loss_2",
                         "n_choosen_experts_mean_epoch_0", "n_choosen_experts_mean_epoch_1",
                         "n_choosen_experts_mean_epoch_2"}


SPLIT = ["dataset.synthetic=true", "dataset.synthetic_n_samples=64",
         "dataset.input_image_shape=[8, 6]", "train.save_experiment_data=true"]


def test_saved_split_equals_jax(tmp_path):
    """``save_experiment_data`` writes what JAX's writes (the scales text
    byte for byte, the indices equal), and a resume reads JAX's saved split
    back into the same arrays."""
    from zdcsim.data import get_train_test_data as jax_split
    from zdcsim_torch.data.dataset import get_train_test_data
    from zdcsim_torch.utils.io import load_scales, load_train_test_indices

    jax_dir, our_dir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    ref = jax_split(jax_load_config(overrides=[*SPLIT, f"config.experiment_dir={jax_dir}"]))
    ours = get_train_test_data(load_config([*SPLIT, f"config.experiment_dir={our_dir}"]))
    with open(f"{jax_dir}/info/proton_scales.txt", "rb") as f:
        ref_text = f.read()
    with open(f"{our_dir}/info/proton_scales.txt", "rb") as f:
        assert f.read() == ref_text
    for a, b in zip(load_train_test_indices(f"{our_dir}/info/"),
                    load_train_test_indices(f"{jax_dir}/info/")):
        np.testing.assert_array_equal(a, b)
    means, scales = load_scales("proton", f"{our_dir}/info/")
    np.testing.assert_array_equal(means, ours.scaler_cond.mean_.astype(np.float32))
    np.testing.assert_array_equal(scales, ours.scaler_cond.scale_.astype(np.float32))
    assert ours.dir_models == ref.dir_models.replace(jax_dir, our_dir) == f"{our_dir}/models/"
    assert os.path.isdir(ours.dir_models)

    # resume from JAX's saved split, with another seed: membership is the saved run's
    resumed = get_train_test_data(load_config([
        "dataset.synthetic=true", "dataset.synthetic_n_samples=64",
        "dataset.input_image_shape=[8, 6]", f"train.checkpoint_experiment_dir={jax_dir}",
        "train.epoch_to_load=2"]))
    assert resumed.dir_models is None  # no save_experiment_data: no checkpoints
    np.testing.assert_array_equal(resumed.test_indices, ref.test_indices)
    for name in ("x_train", "x_test", "y_test", "std_test", "intensity_test", "positions_test"):
        np.testing.assert_array_equal(getattr(resumed, name), getattr(ref, name), err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(["model.n_experts=3", "dataset.input_image_shape=[8, 6]"])
    mods = build_tiny_moe(cfg, SHAPE)
    return cfg, mods, init_state(mods, cfg, 0, "cpu")


def assert_states_equal(a, b):
    from zdcsim_torch.train.checkpoint import _flatten

    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_round_trip(tiny, tmp_path):
    from zdcsim_torch.train.checkpoint import (
        checkpoint_dir, delete_checkpoint, latest_epoch, restore_checkpoint, save_checkpoint)

    cfg, mods, state = tiny
    d = str(tmp_path / "models")
    assert latest_epoch(d) is None
    state = state.to("cpu")
    state.step = state.step + 5
    save_checkpoint(d, 7, state)
    save_checkpoint(d, 3, state)
    assert latest_epoch(d) == 7
    assert os.path.basename(checkpoint_dir(d, 7)) == "state_epoch_7"
    restored = restore_checkpoint(d, 7, init_state(mods, cfg, 42, "cpu"))
    assert_states_equal(restored, state)
    assert restored.step.dtype == restored.gen.opt_state.count.dtype == torch.int32
    assert int(restored.step) == 5
    delete_checkpoint(d, 7)
    assert latest_epoch(d) == 3
    other = load_config(["model.n_experts=2", "dataset.input_image_shape=[8, 6]"])
    other_mods = build_tiny_moe(other, SHAPE)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(d, 3, init_state(other_mods, other, 0, "cpu"))


def saved_epochs(d):
    from zdcsim_torch.train.checkpoint import CKPT_PREFIX

    return sorted(int(n[len(CKPT_PREFIX):]) for n in os.listdir(d) if n.startswith(CKPT_PREFIX))


def test_checkpoint_saver_threshold(tiny, tmp_path):
    from zdcsim_torch.train.hooks import CheckpointSaver

    _, _, state = tiny
    saver = CheckpointSaver(str(tmp_path / "m"), ws_threshold=3.0)
    saver.on_epoch_end(0, {"ws_mean": 5.0}, state)  # above the threshold: no save
    assert saver.saved_epochs == []
    saver.on_epoch_end(1, {"ws_mean": 2.5}, state)  # below: saves
    assert saver.saved_epochs == [1]
    saver.on_epoch_end(2, {}, state)  # no ws metric: no save
    assert saver.saved_epochs == [1]
    none = CheckpointSaver(None, ws_threshold=3.0)  # no save_experiment_data: nothing
    none.on_epoch_end(3, {"ws_mean": 1.0}, state)
    assert none.saved_epochs == []


@pytest.mark.parametrize("use_async", [False, True])
def test_checkpoint_saver_keep_best(tiny, tmp_path, use_async):
    """keep_best keeps the k checkpoints of lowest ws_mean on disk."""
    from zdcsim_torch.train.hooks import CheckpointSaver

    _, _, state = tiny
    d = str(tmp_path / "m")
    saver = CheckpointSaver(d, ws_threshold=100.0, keep_best=2, use_async=use_async)
    saver.on_epoch_end(0, {"ws_mean": 50.0}, state)
    saver.on_epoch_end(1, {"ws_mean": 30.0}, state)
    saver.on_epoch_end(2, {"ws_mean": 40.0}, state)  # drops epoch 0 (ws 50)
    saver.on_train_end([])
    assert saved_epochs(d) == [1, 2]


def test_checkpoint_saver_async_round_trip(tiny, tmp_path):
    """An async save copies to the host before it returns and is on disk
    after ``on_train_end``; it restores bit for bit."""
    from zdcsim_torch.train.checkpoint import restore_checkpoint
    from zdcsim_torch.train.hooks import CheckpointSaver

    cfg, mods, state = tiny
    d = str(tmp_path / "m")
    saver = CheckpointSaver(d, ws_threshold=100.0, use_async=True)
    saver.on_epoch_end(3, {"ws_mean": 10.0}, state)
    saver.on_train_end([])
    assert_states_equal(restore_checkpoint(d, 3, init_state(mods, cfg, 9, "cpu")), state)


def test_async_saver_raises_a_failed_write(tiny, tmp_path):
    """A background write that fails raises from the next wait, once."""
    from zdcsim_torch.train.checkpoint import AsyncSaver

    _, _, state = tiny
    blocker = tmp_path / "models"
    blocker.write_text("a file where the checkpoint directory should go")
    saver = AsyncSaver()
    saver.save(str(blocker), 0, state)
    with pytest.raises(OSError):
        saver.wait()
    saver.close()  # the error was reported: nothing left to raise


def test_step_timer_leaves_out_the_warmup():
    from zdcsim_torch.utils.profiling import StepTimer

    timer = StepTimer(warmup_steps=2)
    for _ in range(3):
        timer.tick()
    assert np.isnan(timer.steps_per_sec)  # one measured step: no interval yet
    timer.tick()
    assert timer.steps_per_sec > 0 and timer.samples_per_sec(8) > 0


def test_prng_streams():
    from zdcsim_torch.utils.prng import eval_generator, fold_epoch_batch

    def draw(g):
        return torch.randn(4, generator=g)

    assert torch.equal(draw(fold_epoch_batch(1, 2, 3)), draw(fold_epoch_batch(1, 2, 3)))
    streams = [draw(fold_epoch_batch(1, 2, 3)), draw(fold_epoch_batch(1, 2, 4)),
               draw(fold_epoch_batch(1, 3, 3)), draw(fold_epoch_batch(2, 2, 3)),
               draw(eval_generator(1, 2))]
    assert all(not torch.equal(a, b) for i, a in enumerate(streams) for b in streams[i + 1:])


def test_loop_refuses_what_is_not_ported(tmp_path):
    from zdcsim_torch.train.loop import train

    for over, item in ((["parallel.n_devices=2"], "item 8"),
                       (["parallel.expert_parallel=2"], "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            train(load_config(run_overrides(tmp_path) + over), device="cpu")
    if not torch.cuda.is_available():  # CUDA by default: no card is an error, not the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(load_config(run_overrides(tmp_path)))


def test_loop_trains_and_resumes_as_jax(tmp_path, caplog):
    """3 epochs, then resumed from epoch 2 of the saved run: epochs 2, 3, 4
    with finite losses; the first run's history has JAX's keys, and its
    profiled epoch leaves a Chrome trace."""
    from zdcsim.models.testing import build_tiny_moe as jax_build_tiny_moe
    from zdcsim.train.loop import train as jax_train
    from zdcsim_torch.train.loop import train

    cfg = load_config(run_overrides(tmp_path, **{"train.epochs": 3, "config.run_name": "first",
                                                 "train.profile_epoch": 1}))
    with caplog.at_level(logging.INFO, logger="zdcsim_torch"):
        history = train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")
    assert [h["epoch"] for h in history] == [0, 1, 2]
    exp_dir = cfg.config.experiment_dir
    assert saved_epochs(f"{exp_dir}/models") == [0, 1, 2]
    assert os.path.isfile(f"{exp_dir}/traces/trace.json")
    assert sum("time split" in r.getMessage() for r in caplog.records) == 3

    jax_cfg = jax_load_config(overrides=run_overrides(tmp_path / "jax", **{"train.epochs": 1}))
    ref = jax_train(jax_cfg, modules=jax_build_tiny_moe(jax_cfg, SHAPE))
    assert set(history[0]) == set(ref[0])

    cfg2 = load_config(run_overrides(tmp_path, **{
        "train.epochs": 5, "config.run_name": "resumed",
        "train.checkpoint_experiment_dir": exp_dir, "train.epoch_to_load": 2}))
    history2, state = train(cfg2, modules=build_tiny_moe(cfg2, SHAPE), return_state=True,
                            device="cpu")
    assert [h["epoch"] for h in history2] == [2, 3, 4]  # resumed from 2: trains 2..4
    assert all(np.isfinite(h["gen_loss"]) and np.isfinite(h["ws_mean"]) for h in history2)
    # epoch 2's checkpoint holds 3 epochs' steps; the resumed run adds 3 epochs
    ckpt = torch.load(f"{exp_dir}/models/state_epoch_2/state.pt", weights_only=True)
    assert int(state.step) == 2 * int(ckpt["step"]) and int(ckpt["step"]) % 3 == 0
