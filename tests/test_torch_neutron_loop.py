"""The neutron family through the port's evaluator, loop, CLI twin,
checkpoints and ``FastSim``, on the CPU.

- The evaluator: JAX's ``build_evaluator`` on the neutron modules
  (``GeneratorNeutron`` v1, ``norm=batch``, width 0.125, E=2) and the
  port's on the JAX state carried across, its BatchNorm running statistics
  drawn (eval reads them), the port handed JAX's draws
  (``tests/test_torch_evaluator.py``'s :func:`jax_draws`): 44x44 showers
  through kernel E's plain version (``eval.fused_epilogue``; JAX's Pallas
  kernel in interpret mode) on the tiled switch decode, and a chunk whose
  tile is 1 (every expert, then the gather). W1 metrics rtol 1e-5 (a std
  over the runs at 1e-5 of the W1 it is taken over), routing counts equal.
- ``cli_torch.py --config zdcsim/config/neutron.yaml`` (the preset,
  ``norm=group``) trains one epoch at width 0.125 on a synthetic split,
  saving a checkpoint, then resumes from it for a second epoch.
- A ``norm=batch`` train state after one step, checkpointed and served by
  ``FastSim.from_checkpoint`` on ``f32`` (the BatchNorm folded into the
  weights with the trained running statistics), equals the generator
  module's eval forward on the same noise (rtol 1e-4 in log space, JAX's
  rule for the fold).
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evaluator import WS_KEYS, jax_draws
from test_torch_neutron_train_step import E, make_batch, overrides
from zdcsim.config import load_config as jax_load_config
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.train.evaluate import build_evaluator as jax_build_evaluator
from zdcsim.train.state import init_state_jit
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import train_state_from_jax
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.models import bn_buffers, build_moe, expert_slices
from zdcsim_torch.train.checkpoint import save_checkpoint
from zdcsim_torch.train.evaluate import build_evaluator
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (44, 44)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch_norm_state():
    """JAX's modules and state under ``norm=batch``, the running statistics
    drawn (mean N(0, 0.3), var 0.5 + U(0, 1)), and the port's carried
    state."""
    cfg = jax_load_config(overrides=overrides("batch"))
    mods = jax_build_moe(cfg)
    state = init_state_jit(mods, cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray((0.3 * rng.standard_normal(a.shape) if path[-1].key == "mean"
                                     else 0.5 + rng.random(a.shape)).astype(np.float32)),
        state.gen.stats)
    state = state.replace(gen=state.gen.replace(stats=stats))
    return mods, state, train_state_from_jax(state, "cpu")


# a random generator's W1 (~9e3) is about equal over the runs: its std over
# them (~1) keeps only the digits below the runs' agreement
STD_OF = {"ws_std": "ws_mean", "ws_std_exp": "ws_mean_exp"}
CASES = {  # name: (n test showers, chunk, epoch, eval overrides)
    "switch_decode_fused": (64, 32, 0, ["eval.fused_epilogue=true"]),
    "tile1_dense_gather": (21, 32, 10, []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluator_matches_jax(batch_norm_state, case):
    mods, state, port_state = batch_norm_state
    n, chunk, epoch, over = CASES[case]
    arrays = {"real": jnp.log1p(jnp.abs(jax.random.normal(jax.random.PRNGKey(2),
                                                          (n, *SHAPE, 1))) * 30),
              "cond": jax.random.normal(jax.random.PRNGKey(3), (n, 9))}
    key = jax.random.PRNGKey(7)
    ref = jax_build_evaluator(mods, jax_load_config(overrides=overrides("batch", *over)),
                              chunk_size=chunk)(state, arrays, epoch=epoch, key=key)
    gumbel, noise = jax_draws(key, n, chunk, epoch, mods.noise_dim)
    pcfg = load_config(overrides("batch", *over))
    ours = build_evaluator(build_moe(pcfg), pcfg, chunk_size=chunk)(
        port_state, {k: np.array(v) for k, v in arrays.items()}, epoch, noise=noise,
        gumbel=gumbel)
    assert set(ours) == set(ref)
    for k in WS_KEYS:
        scale = np.abs(np.asarray(ref[k]))
        if k in STD_OF:  # the std over runs against the W1 it is taken over
            scale = np.maximum(scale, np.abs(np.asarray(ref[STD_OF[k]])))
        assert np.all(np.abs(ours[k] - np.asarray(ref[k])) <= 1e-5 * scale), (k, ours[k], ref[k])
    np.testing.assert_array_equal(ours["eval_expert_counts"], np.asarray(ref["eval_expert_counts"]))


def cli(cwd, *args):
    """``python cli_torch.py *args`` from ``cwd`` at two threads."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "cli_torch.py"), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout + proc.stderr


def test_cli_trains_the_neutron_preset_and_resumes(tmp_path):
    """One epoch of the preset from ``--config``, a checkpoint, then the
    resume trains epoch 1 from it."""
    data = ["dataset.synthetic=true", "dataset.synthetic_n_samples=40", "train.batch_size=16",
            "model.generator.width=0.125", "model.n_experts=2", "eval.fused_epilogue=true",
            "train.save_experiment_data=true", "train.ws_threshold_model_save=1e30",
            f"train.save_experiments_dir={tmp_path}/", "config.run_name=neutron"]
    preset = os.path.join(REPO, "zdcsim", "config", "neutron.yaml")
    log = cli(tmp_path, "--cpu", "--config", preset, "--override", *data, "train.epochs=1")
    assert "GeneratorNeutron" in log and "DiscriminatorNeutron" in log, log
    assert "AuxRegNeutron" in log and "image=(44, 44)" in log, log
    (run,) = glob.glob(str(tmp_path / "neutron_*"))
    assert os.path.isfile(os.path.join(run, "models", "state_epoch_0", "state.pt"))
    log = cli(tmp_path, "--cpu", "--config", preset, "--override", *data, "train.epochs=2",
              f"train.checkpoint_experiment_dir={run}", "train.epoch_to_load=0")
    assert "epoch 1 (" in log and "Final epoch metrics" in log, log


def test_batch_norm_checkpoint_serves_as_the_module(tmp_path):
    """``FastSim.from_checkpoint`` folds the trained running statistics: its
    ``f32`` showers equal each routed expert's module eval forward (EMA
    parameters, the state's statistics) on the same noise."""
    cfg = load_config(overrides("batch"))
    mods = build_moe(cfg)
    state = init_state(mods, cfg, seed=0, device="cpu")
    b = 8
    batch = {k: torch.from_numpy(v) for k, v in make_batch(4, b).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(5), mods, b, "cpu")
    state, _ = build_train_step(mods, cfg)(state, batch, draws, 0)
    assert not torch.equal(state.gen.stats["MaskedBatchNorm_2|var"],
                           torch.ones_like(state.gen.stats["MaskedBatchNorm_2|var"]))
    save_checkpoint(str(tmp_path), 0, state)
    eng = FastSim.from_checkpoint(cfg, str(tmp_path), 0, device="cpu", precision="f32",
                                  batch_size=16)
    assert eng.fast_neutron  # folded
    g = torch.Generator().manual_seed(6)
    cond, noise = torch.randn((16, 9), generator=g), torch.randn((16, 10), generator=g)
    imgs, idx = eng.simulate_switch(cond, noise=noise, return_experts=True)
    experts = [{**p, **bn_buffers(s)} for p, s in zip(expert_slices(state.ema_gen_params, E),
                                                      expert_slices(state.gen.stats, E))]
    with torch.no_grad():
        ref = torch.stack([torch.func.functional_call(mods.generator, experts[int(e)],
                                                      (noise[i:i + 1], cond[i:i + 1]))[0, ..., 0]
                           for i, e in enumerate(idx)])
    assert set(idx.tolist()) == set(range(E))
    np.testing.assert_allclose(torch.log1p(imgs).numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="needs the run's cfg"):
        FastSim.from_state(mods, state, device="cpu")
