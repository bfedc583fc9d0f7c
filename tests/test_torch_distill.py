"""Distillation (``zdcsim/inference/distill.py``) in the port: the cosine
schedule against optax's, ``k`` inner steps of ``build_distill_step`` on the
draws that JAX's step makes (its ``jax.random.split`` / ``randint`` /
``normal`` calls repeated here and handed to the port) against JAX's step,
the convergence twin of ``tests/test_distill.py``, and ``distill_torch.py``
on a tiny pool.

Tolerances: the schedule within 2 float32 ulps of ``lr`` (optax's float32
``cos`` and torch's differ by an ulp at some counts); the metrics within
rtol 1e-4; parameters and Adam's moments after ``k`` inner steps within
rtol 1e-4 / atol 1e-6 of JAX's, every element of the tiny stand-ins after
5 steps. On the proton student (one step), Adam's moments are held so
everywhere, and so are the parameters wherever the gradient is resolved in
float32: Adam's first update is ``lr * g / (|g| + 1e-8)``, so an element
whose gradient is under 3e-5 of its leaf's largest moves by up to ``lr``
on its rounding (544 of 8.8 million in Dense_1's kernel here, all under
1.1e-5 of their leaf's largest gradient), and the biases of Conv_0-Conv_2
under a GroupNorm of one channel a group have a gradient that is zero in
exact arithmetic (1e-7 of the tree's largest): those are held within
Adam's bound of ``2 lr``. A second step spreads those moves into every
gradient, so the proton student is held after one. The full-width proton
teacher runs in float32 in both packages here (the scripts' bf16 teacher
rounds differently in XLA and in PyTorch, and that difference, not the
step, would set the tolerance)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zdcsim.config import load_config as jax_load_config
from zdcsim.inference.distill import build_distill_step as jax_build_distill_step
from zdcsim.models import build_moe as jax_build_moe
from zdcsim.models.proton_fast import fast_generator_apply as jax_fast_generator_apply
from zdcsim.models.testing import build_tiny_moe as jax_build_tiny_moe
from zdcsim.train.state import init_state as jax_init_state
from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config
from zdcsim_torch.convert import from_jax_params, from_state_dict, to_state_dict
from zdcsim_torch.inference.distill import (
    build_distill_step, distill_generator, proton_teacher, router_argmax,
)
from zdcsim_torch.models import build_moe
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.state import adam_init, cosine_decay_schedule, init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(REPO, "artifacts", "gate", "gate_serving_weights.npz")
SHAPE = (8, 6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lr,steps", [(2e-3, 3000), (3e-3, 600), (1e-3, 7)])
def test_cosine_schedule_equals_optax(lr, steps):
    ref = optax.cosine_decay_schedule(lr, steps)
    ours = cosine_decay_schedule(lr, steps)
    counts = np.arange(steps + 3, dtype=np.int32)
    a = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    b = np.array([ours(torch.tensor(c)).item() for c in counts], dtype=np.float32)
    assert ours(torch.tensor(0)).dtype == torch.float32
    assert np.all(np.abs(a - b) <= 2 * np.spacing(np.float32(lr))), np.abs(a - b).max()
    assert b[0] == np.float32(lr) and b[steps] == b[steps + 2] == 0.0


def jax_draws(key, k, n_pool, batch, noise_dim):
    """The draws of JAX's ``scan_body`` (``zdcsim/inference/distill.py:83-86``)
    on the step's ``key``, as the port takes them."""
    out = []
    for kk in jax.random.split(key, k):
        k_row, k_z = jax.random.split(kk)
        rows = jax.random.randint(k_row, (batch,), 0, n_pool)
        noise = jax.random.normal(k_z, (batch, noise_dim), jnp.float32)
        out.append((torch.from_numpy(np.array(rows)).long(), torch.from_numpy(np.array(noise))))
    return out


def assert_close(ours, ref, what, resolved=None):
    """Leaf by leaf within rtol 1e-4 / atol 1e-6; where ``resolved`` (a
    mask per leaf) is given, on its elements."""
    fo, fr = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(fo) == sorted(fr), what
    for k in fr:
        m = np.ones(fr[k].shape, bool) if resolved is None else resolved[k]
        np.testing.assert_allclose(fo[k][m], fr[k][m], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {k}")


def resolved_gradients(mu):
    """Per leaf, the elements whose first-step gradient (``mu``) is resolved
    in float32: at least 3e-5 of its leaf's largest, in a leaf whose largest
    is at least 1e-5 of the tree's."""
    leaves = {k: np.abs(v) for k, v in _leaves(mu)}
    top = max(float(v.max()) for v in leaves.values())
    return {k: (v >= 3e-5 * v.max()) & (v.max() >= 1e-5 * top) for k, v in leaves.items()}


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    return [kv for k, v in tree.items() for kv in _leaves(v, f"{prefix}/{k}")]


def compare_steps(j_student_apply, j_teacher, j_router, student_params, p_student_apply,
                  p_teacher, p_router, cond_pool, k, batch, noise_dim, lr=2e-3, steps=100,
                  strict=True):
    """``k`` inner steps of both packages from one student tree (Flax layout,
    stacked) on JAX's draws; asserts params and Adam's moments close (with
    ``strict`` off: the parameters where the gradient is resolved, the rest
    within ``2 lr`` a step)."""
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    key = jax.random.PRNGKey(21)
    j_step = jax_build_distill_step(j_student_apply, j_teacher, j_router, tx, noise_dim,
                                    inner_steps=k)
    j_params = jax.tree_util.tree_map(jnp.asarray, student_params)
    j_opt = tx.init(j_params)
    j_params, j_opt, j_met = j_step(j_params, j_opt, jnp.asarray(cond_pool), key, batch)

    p_step = build_distill_step(p_student_apply, p_teacher, p_router,
                                cosine_decay_schedule(lr, steps), noise_dim, inner_steps=k)
    params = {n: v.contiguous() for n, v in to_state_dict(student_params, stacked=True).items()}
    draws = jax_draws(key, k, len(cond_pool), batch, noise_dim)
    params, opt, met = p_step(params, adam_init(params), torch.from_numpy(cond_pool), batch,
                              draws=draws)
    assert int(opt.count) == int(j_opt[0].count) == k
    for name in ("loss", "pix", "chsum"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=1e-4, err_msg=name)
    ours = from_state_dict(params, stacked=True)
    resolved = None if strict else resolved_gradients(j_opt[0].mu)
    assert_close(ours, j_params, "params", resolved)
    if not strict:
        for (name, a), (_, b) in zip(sorted(_leaves(ours)), sorted(_leaves(j_params))):
            assert np.all(np.abs(a - b) <= 2 * lr * k), name
        n_free = sum(int((~m).sum()) for m in resolved.values())
        assert n_free < 2e-2 * sum(m.size for m in resolved.values()), n_free
    assert_close(from_state_dict(opt.mu, stacked=True), j_opt[0].mu, "mu")
    assert_close(from_state_dict(opt.nu, stacked=True), j_opt[0].nu, "nu")
    return params


def tiny_systems():
    cfg = jax_load_config(overrides=["model.n_experts=3", "train.batch_size=16",
                                     f"dataset.input_image_shape=[{SHAPE[0]}, {SHAPE[1]}]"])
    jmods = jax_build_tiny_moe(cfg, SHAPE)
    pmods = build_tiny_moe(load_config(["model.n_experts=3"]), SHAPE)
    return cfg, jmods, pmods


def test_inner_steps_match_jax_on_tiny_modules():
    cfg, jmods, pmods = tiny_systems()
    t_state = jax_init_state(jmods, cfg, jax.random.PRNGKey(0))
    tp, rp = t_state.gen.params, t_state.router.params
    sp = jax.tree_util.tree_map(np.array, jax_init_state(jmods, cfg, jax.random.PRNGKey(9))
                                .gen.params)
    cond_pool = np.random.default_rng(3).normal(size=(256, 9)).astype(np.float32)

    def j_teacher(noise, cond):
        return jmods.generator.apply({"params": tp}, noise, cond, False)

    def j_router(cond):
        return jnp.argmax(jmods.router.apply({"params": rp}, cond)[1], axis=-1)

    def j_student(params, noise, cond):
        return jmods.generator.apply({"params": params}, noise, cond, False)

    t_sd = to_state_dict(jax.tree_util.tree_map(np.array, tp), stacked=True)
    r_sd = to_state_dict(jax.tree_util.tree_map(np.array, rp))
    compare_steps(j_student, j_teacher, j_router, sp,
                  pmods.generate, lambda z, c: pmods.generate(t_sd, z, c),
                  router_argmax(load_config(["model.n_experts=3"]).model, r_sd, "cpu"),
                  cond_pool, k=5, batch=16, noise_dim=jmods.noise_dim)


def test_inner_steps_match_jax_on_a_proton_student():
    """A ``Generator(width=0.125)`` student behind the full-width teacher
    artifact (float32 ``fast_generator_apply`` in both) at batch 4."""
    gp, _, rp, _ = jax_load(TEACHER)
    cfg_w = jax_load_config(overrides=["model.n_experts=3", "model.generator.width=0.125"])
    jmods = jax_build_moe(cfg_w)
    z0, c0 = jnp.zeros((2, jmods.noise_dim)), jnp.zeros((2, jmods.cond_dim))
    sp = jax.tree_util.tree_map(np.array, jmods.generator.init(
        {"params": jax.random.PRNGKey(11)}, z0, c0, False)["params"])
    tp = jax.tree_util.tree_map(jnp.asarray, gp)
    cond_pool = np.random.default_rng(4).normal(size=(64, 9)).astype(np.float32)

    def j_teacher(noise, cond):
        return jax.vmap(jax_fast_generator_apply, in_axes=(0, None, None))(tp, noise, cond)

    def j_router(cond):
        return jnp.argmax(jmods.router.apply({"params": rp}, cond)[1], axis=-1)

    def j_student(params, noise, cond):
        return jmods.generator.apply({"params": params}, noise, cond, False)

    gen, r_sd = from_jax_params(gp, rp)
    pcfg = load_config(["model.n_experts=3", "model.generator.width=0.125"])
    pmods = build_moe(pcfg)
    compare_steps(j_student, j_teacher, j_router, sp, pmods.generate,
                  proton_teacher(gen, "cpu", torch.float32), router_argmax(pcfg.model, r_sd, "cpu"),
                  cond_pool, k=1, batch=4, noise_dim=jmods.noise_dim, strict=False)


def test_distill_converges_toward_teacher():
    """The port's twin of ``tests/test_distill.py:17``: the student's gap to
    the teacher falls 5x in 600 steps."""
    cfg = load_config(["model.n_experts=3", "train.batch_size=16"])
    mods = build_tiny_moe(cfg, SHAPE)
    teacher = init_state(mods, cfg, 0, "cpu")
    student0 = init_state(mods, cfg, 9, "cpu").gen.params
    cond_pool = np.random.default_rng(3).normal(size=(256, 9)).astype(np.float32)
    r_apply = router_argmax(cfg.model, teacher.router.params, "cpu")

    def t_apply(noise, cond):
        return mods.generate(teacher.gen.params, noise, cond)

    z = torch.randn((64, mods.noise_dim), generator=torch.Generator().manual_seed(77))
    c = torch.from_numpy(cond_pool[:64])

    def gap(params):
        with torch.no_grad():
            return float(((mods.generate(params, z, c) - t_apply(z, c)) ** 2).mean())

    params, metrics = distill_generator(mods, student0, t_apply, r_apply, cond_pool,
                                        torch.Generator().manual_seed(1), mods.noise_dim,
                                        steps=600, batch_size=32, lr=3e-3, inner_steps=25)
    assert np.isfinite(metrics["loss"]) and set(metrics) == {"loss", "pix", "chsum"}
    g0, g1 = gap(student0), gap(params)
    assert g1 < g0 / 5, f"distillation did not converge: {g0} -> {g1}"


def test_step_is_reproducible_and_leaves_its_inputs():
    """Two calls from one state on one generator seed are equal bit for bit;
    the state passed in is left as it was."""
    cfg = load_config(["model.n_experts=3"])
    mods = build_tiny_moe(cfg, SHAPE)
    teacher = init_state(mods, cfg, 0, "cpu")
    params = init_state(mods, cfg, 9, "cpu").gen.params
    before = {k: v.clone() for k, v in params.items()}
    step = build_distill_step(mods.generate,
                              lambda z, c: mods.generate(teacher.gen.params, z, c),
                              router_argmax(cfg.model, teacher.router.params, "cpu"),
                              cosine_decay_schedule(1e-3, 100), mods.noise_dim, inner_steps=3)
    pool = torch.randn((32, 9), generator=torch.Generator().manual_seed(2))
    outs = [step(params, adam_init(params), pool, 8, torch.Generator().manual_seed(5))
            for _ in range(2)]
    for k in params:
        assert torch.equal(outs[0][0][k], outs[1][0][k]) and torch.equal(params[k], before[k])
    assert not torch.equal(outs[0][0]["Dense_0.weight"], params["Dense_0.weight"])
    with pytest.raises(ValueError, match="3 draws"):
        step(params, adam_init(params), pool, 8, draws=[])
    # chip_smoke.py phase 21's card-against-CPU comparison of a call: 0 on equal
    # calls, beyond 1 where a parameter moved by more than 2 lr a step
    import chip_smoke

    worst = chip_smoke.distill_agreement(outs[0], outs[1], 1e-3, 3)
    assert all(v["ratio"] == 0.0 for v in worst.values()), worst
    moved = ({**outs[1][0], "Dense_0.weight": outs[1][0]["Dense_0.weight"] + 7e-3},
             *outs[1][1:])
    worst = chip_smoke.distill_agreement(outs[0], moved, 1e-3, 3)
    assert worst["params"]["ratio"] > 1.0 and worst["params"]["at"] == "Dense_0.weight"


@pytest.mark.parametrize("family", ["proton", "neutron"])
def test_distill_torch_writes_an_artifact_that_fastsim_serves(tmp_path, family):
    """``distill_torch.py --device cpu`` on a pool of 80 conditions (2
    updates of batch 2, gates on 8 test conditions, one draw): its record,
    and an artifact with the scripts' meta that ``FastSim`` serves on
    ``int8`` and JAX's loader reads as the port's does."""
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    out = tmp_path / "student.npz"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "distill_torch.py"), "--family", family,
         "--steps", "2", "--inner-steps", "1", "--batch", "2", "--n-samples", "100",
         "--n-gate", "8", "--draws", "1", "--device", "cpu", "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert {"width", "fidelity_x_floor", "teacher_x_floor", "pass", "distill_metrics", "steps",
            "seconds", "device"} <= set(rec)
    assert rec["width"] == 0.125 and rec["steps"] == 2 and rec["out"] == str(out)
    assert rec["device"] == {"platform": "cpu", "kind": "cpu"}
    assert all(np.isfinite(v) for v in rec["distill_metrics"].values())
    gp, gs, rp, meta = load_serving_artifact(str(out))
    keys = {"weights", "width", "source", "fidelity_x_floor", "steps"}
    keys |= {"epoch"} if family == "proton" else {"family", "norm", "teacher_x_floor"}
    assert set(meta) == keys and meta["weights"] == "distilled-student"
    assert float(meta["fidelity_x_floor"]) == rec["fidelity_x_floor"]
    ref = jax_load(str(out))
    for a, b in zip((gp, gs, rp), ref[:3]):
        for (k, x), (_, y) in zip(sorted(_leaves(a)), sorted(_leaves(b))):
            assert np.array_equal(x, y), k
    over = [*([*NEUTRON_OVERRIDES, "model.norm=none"] if family == "neutron" else []),
            "model.generator.width=0.125"]
    eng = FastSim(gp, rp, batch_size=8, precision="int8", device="cpu", cfg=load_config(over))
    cond = np.random.default_rng(0).standard_normal((8, 9)).astype(np.float32)
    imgs = eng.simulate_bulk(cond, generator=torch.Generator().manual_seed(0))
    assert imgs.shape == ((8, 44, 44) if family == "neutron" else (8, 56, 30))
    assert torch.isfinite(imgs).all()
    if family == "neutron":
        assert eng.fast_neutron


def test_the_families_share_the_condition_pool():
    """The neutron split's ``y_train`` equals the proton split's (one seed, one
    synthetic kinematics stream): ``chip_smoke.py`` phase 21 distils both
    families on the proton gate split's conditions."""
    from zdcsim_torch.data.dataset import get_train_test_data

    import fidelity_torch as ft

    over = [*ft.GATE_OVERRIDES, "dataset.synthetic_n_samples=2560"]
    a = get_train_test_data(load_config(over)).y_train
    b = get_train_test_data(load_config([*NEUTRON_OVERRIDES, *over])).y_train
    assert a.shape == (2048, 9) and np.array_equal(a, b)
