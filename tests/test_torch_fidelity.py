"""``fidelity_torch.py`` and the float precisions of the port's ``FastSim``
against the JAX package, on the CPU: the gate's arithmetic against
``fidelity.py``'s formulas, its target and config resolution (mirrors of
tests/test_fidelity_cli.py), what it refuses, and ``precision="f32"`` and
``"bf16"`` on the full-width teacher against the JAX engine."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidelity_torch as ft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(REPO, "artifacts", "gate", "gate_serving_weights.npz")
B = 4


def _jax_gate_numbers(ch_real, ch_gens):
    """fidelity.py:224-262, on numpy inputs."""
    from zdcsim.ops.ws import wasserstein_per_channel

    ch_real = jnp.asarray(ch_real)
    n = ch_real.shape[0]
    perm = np.random.default_rng(0).permutation(n)
    half = n // 2
    ch_perm = ch_real[perm]
    floor = float(jnp.mean(wasserstein_per_channel(ch_perm[:half], ch_perm[half:2 * half])))
    scale = float(jnp.mean(ch_real))
    ws_full, ws_half = [], []
    for g in ch_gens:
        g = jnp.asarray(g)
        ws_full.append(float(jnp.mean(wasserstein_per_channel(ch_real, g))))
        ws_half.append(float(jnp.mean(wasserstein_per_channel(ch_perm[:half],
                                                              g[perm][half:2 * half]))))
    ws_full = float(np.mean(ws_full))
    ratio = float(np.mean(ws_half)) / max(floor, 1e-9)
    return {"value": ratio, "vs_baseline": ft.CRITERION / max(ratio, 1e-9), "ws_mean": ws_full,
            "ws_mean_rel": ws_full / max(scale, 1e-9), "ws_real_floor": floor}


@pytest.mark.parametrize("n", [400, 517])
def test_fidelity_record_matches_jax_formulas(n):
    rng = np.random.default_rng(n)
    ch_real = rng.gamma(4.0, 300.0, (n, 5)).astype(np.float32)
    ch_gens = [(rng.gamma(4.0, 300.0, (n, 5)) * (1.0 + 0.05 * d)).astype(np.float32)
               for d in range(3)]
    rec = ft.fidelity_record(torch.from_numpy(ch_real), [torch.from_numpy(g) for g in ch_gens])
    ref = _jax_gate_numbers(ch_real, ch_gens)
    assert rec["metric"] == "fastsim_fidelity" and rec["unit"] == "x_floor"
    assert rec["criterion_x_floor"] == ft.CRITERION == 1.5
    # the record is rounded as fidelity.py rounds it: within one unit of the
    # last kept digit of the JAX number
    for key, digits in (("value", 3), ("vs_baseline", 3), ("ws_mean", 1), ("ws_mean_rel", 4),
                        ("ws_real_floor", 1)):
        assert abs(rec[key] - ref[key]) <= 10.0 ** -digits, (key, rec[key], ref[key])


def test_resolve_target_npz_path():
    path = "artifacts/gate/student_w0.125_serving_weights.npz"
    assert ft._resolve_target(path) == (path, None)


def test_resolve_target_artifact_keyword():
    assert ft._resolve_target("artifact") == (ft.ARTIFACT_PATH, None)


def test_resolve_target_run_dir():
    assert ft._resolve_target("experiments/some_run_dir") == (None, "experiments/some_run_dir")


def test_resolve_target_default_falls_back_to_committed_artifact(monkeypatch):
    import fidelity

    monkeypatch.chdir(REPO)
    assert ft.ARTIFACT_PATH == fidelity.ARTIFACT_PATH and os.path.exists(ft.ARTIFACT_PATH)
    assert ft.DEFAULT_RUN_GLOBS == fidelity.DEFAULT_RUN_GLOBS
    if ft._resolve_default_run() is not None:
        pytest.skip("an on-disk gate run dir exists; default resolves to it")
    assert ft._resolve_target(None) == (ft.ARTIFACT_PATH, None)


def test_artifact_model_config_proton_student():
    assert ft._artifact_model_config({"weights": "distilled-student", "width": "0.125"}) == [
        "model.generator.width=0.125"]


def test_artifact_model_config_teacher_plain():
    assert ft._artifact_model_config({"weights": "ema", "epoch": "249"}) == []


def test_artifact_model_config_neutron_raises():
    """The neutron family is ported: its overrides are ``fidelity.py``'s
    (the preset of zdcsim/config/neutron.yaml first, then width, norm and
    generator version), and they load a config equal to JAX's on the held
    keys."""
    import fidelity
    from zdcsim.config import load_config as jax_config
    from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config

    meta = {"weights": "distilled-student", "family": "neutron", "width": "0.5",
            "norm": "none", "generator_version": "v1"}
    overrides = ft._artifact_model_config(meta)
    ref, cfg_path = fidelity._artifact_model_config(meta)
    assert overrides == [*NEUTRON_OVERRIDES, *ref]
    ours, theirs = load_config(overrides), jax_config(cfg_path, overrides=ref)
    for key in ("architecture", "norm"):
        assert getattr(ours.model, key) == theirs.model[key] == {"architecture": "neutron",
                                                                 "norm": "none"}[key]
    assert ours.model.generator.width == theirs.model.generator.width == 0.5
    assert ours.dataset.zdc_type == theirs.dataset.zdc_type == "neutron"
    assert list(ours.dataset.input_image_shape) == theirs.dataset.input_image_shape == [44, 44]
    assert ft._artifact_model_config({"family": "neutron", "norm": "group"}) == [
        *NEUTRON_OVERRIDES, "model.norm=group"]


def test_gate_constants_equal_fidelity_py():
    import fidelity

    assert (ft.CRITERION, ft.N_DRAWS, ft.CALIBRATION_EPOCHS) == (
        fidelity.CRITERION, fidelity.N_DRAWS, fidelity.CALIBRATION_EPOCHS)


def test_gate_refuses_run_dirs_and_the_neutron_family():
    """A run directory gates (``tests/test_torch_fidelity_rundir.py``) and
    refuses one without checkpoints, as ``fidelity.py`` does; a neutron
    artifact gates (here on a slice of the test split, one draw) with its
    family's record."""
    with pytest.raises(FileNotFoundError, match="no state_epoch_. checkpoints under"):
        ft.run_gate("experiments/some_run_dir", device="cpu")
    from zdcsim_torch.config import load_config

    cfg = load_config([*ft.GATE_OVERRIDES, *ft._artifact_model_config({"family": "neutron"}),
                       "dataset.synthetic_n_samples=2560"])
    cond, real = ft.gate_split(cfg)
    assert real.shape[1:] == (44, 44)
    rec = ft.run_gate(os.path.join(REPO, "artifacts", "gate",
                                   "neutron_student_w0.125_serving_weights.npz"), "int8",
                      device="cpu", data=(cond[:256], real[:256]), n_draws=1)
    assert rec["family"] == "neutron" and rec["n_test"] == 256 and rec["width"] == 0.125
    assert rec["criterion"].startswith("teacher-relative: <= 1.1x teacher (5.500x floor)")
    # value is rounded to 3 digits, vs_baseline computed from the unrounded ratio
    assert abs(rec["vs_baseline"] - 5.5 / rec["value"]) <= 2e-3 * rec["vs_baseline"]
    assert np.isfinite(rec["value"]) and rec["device"] == {"platform": "cpu", "kind": "cpu"}


def test_neutron_gate_split_equals_jax():
    """The neutron gate's test side (``fidelity.py`` with the neutron preset,
    here at 2560 synthetic events): conditions and real showers [n, 44, 44]
    bit-equal to JAX's."""
    from zdcsim.config import load_config as jax_config
    from zdcsim.data import get_train_test_data as jax_split
    from zdcsim.data.loader import split_to_arrays as jax_arrays
    from zdcsim_torch.config import load_config

    overrides = [*ft.GATE_OVERRIDES, "dataset.synthetic_n_samples=2560"]
    cond, real = ft.gate_split(load_config([*ft._artifact_model_config({"family": "neutron"}),
                                            *overrides]))
    ref = jax_arrays(jax_split(jax_config(os.path.join(REPO, "zdcsim", "config", "neutron.yaml"),
                                          overrides=overrides)), False)
    assert real.shape == (512, 44, 44)
    np.testing.assert_array_equal(cond, ref["cond"])
    np.testing.assert_array_equal(real, ref["real"][..., 0])


@pytest.mark.parametrize("meta", [
    {"family": "neutron", "weights": "distilled-student", "width": "0.125", "norm": "none",
     "teacher_x_floor": "5.0"},
    {"family": "neutron", "weights": "ema", "norm": "group", "epoch": "149"},
    {"weights": "distilled-student", "width": "0.125"},
])
def test_neutron_record_follows_fidelity_py(meta):
    """``criterion`` and ``vs_baseline`` as ``fidelity.py:269-288``: a
    neutron student teacher-relative at ``NEUTRON_REL_CRITERION``, the
    neutron teacher informational (``vs_baseline`` null), a proton record
    untouched."""
    import fidelity

    assert ft.NEUTRON_REL_CRITERION == fidelity.NEUTRON_REL_CRITERION == 1.10
    rng = np.random.default_rng(7)
    ch_real = torch.from_numpy(rng.gamma(4.0, 300.0, (300, 5)).astype(np.float32))
    ch_gens = [torch.from_numpy((rng.gamma(4.0, 300.0, (300, 5)) * 1.3).astype(np.float32))]
    rec = ft.fidelity_record(ch_real, ch_gens, meta)
    ratio = _jax_gate_numbers(ch_real.numpy(), [g.numpy() for g in ch_gens])["value"]
    if meta.get("family") != "neutron":
        assert "criterion" not in rec and rec["vs_baseline"] == round(1.5 / ratio, 3)
    elif "teacher_x_floor" in meta:
        bar = 1.10 * 5.0
        assert rec["criterion"] == f"teacher-relative: <= 1.1x teacher ({bar:.3f}x floor)"
        assert abs(rec["vs_baseline"] - bar / ratio) <= 1e-3
    else:
        assert rec["vs_baseline"] is None
        assert rec["criterion"].startswith("informational (neutron family saturates")


def test_main_prints_the_record_last(monkeypatch, capsys):
    calls = []

    def fake_gate(target, precision, device, **options):
        calls.append((target, precision, device, options))
        print("routing line")
        return {"metric": "fastsim_fidelity", "value": 1.2}

    monkeypatch.setattr(ft, "run_gate", fake_gate)
    assert ft.main(["artifact", "--device", "cpu"]) == 0
    assert ft.main(["x.npz", "int8_pallas"]) == 0
    assert ft.main(["run", "f32", "--epoch", "3", "--weights", "raw", "--override", "a.b=1"]) == 0
    default = {"epoch": None, "weights": "ema", "overrides": []}
    assert calls == [("artifact", "int8", "cpu", default), ("x.npz", "int8_pallas", None, default),
                     ("run", "f32", None, {"epoch": 3, "weights": "raw", "overrides": ["a.b=1"]})]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"metric": "fastsim_fidelity", "value": 1.2}


@pytest.fixture(scope="module")
def teacher():
    from zdcsim.utils.artifact import load_serving_artifact as jax_load

    gp, _, rp, _ = jax_load(TEACHER)
    return gp, rp


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fastsim_float_precisions_match_jax_engine(teacher, precision):
    """The float decode end to end through ``simulate_switch`` at B=4, tile
    4, with the JAX engine's own noise (drawn from the chunk key
    ``fold_in(key, 0)`` in the compute dtype)."""
    from zdcsim.config import load_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim_torch.inference.engine import FastSim

    gp, rp = teacher
    cond = np.random.default_rng(3).standard_normal((B, 9)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jeng = JaxFastSim(build_moe(load_config(overrides=["model.n_experts=3"])), gp, {}, rp,
                      batch_size=B, precision=precision)
    jeng._build_switch(tile=4)
    ref, ref_ids = jeng.simulate_switch(cond, key, return_experts=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    jdt = jnp.float32 if precision == "f32" else jnp.bfloat16
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, 10), jdt)
                       .astype(jnp.float32))

    eng = FastSim(gp, rp, batch_size=B, precision=precision, device="cpu")
    eng._build_switch(tile=4)
    out, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    out, ids = out.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ref_ids)
    assert out.shape == ref.shape == (B, 56, 30) and out.dtype == np.float32
    log_ref, log_out = np.log1p(ref), np.log1p(out)
    err = np.abs(log_out - log_ref).max()
    print(f"{precision} FastSim max |log1p port - log1p jax| = {err}")
    if precision == "f32":
        # tolerance of tests/test_torch_teacher.py::test_float_generator_matches_jax_module
        np.testing.assert_allclose(log_out, log_ref, rtol=2e-3, atol=2e-3)
    else:
        # bf16 rounds at other places in the two frameworks, and a rounding
        # difference cascades as in the int8 paths: their bound
        # (tests/test_pallas_decode.py:203)
        assert err < 0.05 * np.abs(log_ref).max() + 0.05


def test_fastsim_default_precision_is_f32():
    import inspect

    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim_torch.inference.engine import FastSim

    default = inspect.signature(FastSim).parameters["precision"].default
    assert default == inspect.signature(JaxFastSim).parameters["precision"].default == "f32"
