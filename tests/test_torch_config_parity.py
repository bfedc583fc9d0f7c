"""The port's config loading against the JAX package's, on the CPU.

- Each override value of :data:`OVERRIDES` parses as
  ``zdcsim.config._parse_override_value`` parses it, in value and type
  (YAML 1.1's ``yes``/``off``, hex, ``.inf``, quoted strings, flow
  mappings, JAX's float fallback for ``5e-5``, text that is not YAML kept
  as given); the YAML that the port does not read (:data:`UNREAD`) raises.
- ``load_config`` on sets of overrides and on YAML files (the reference's
  legacy router strengths, YAML booleans, keys that the defaults lack in a
  section and at the top level, a file and overrides together) equals
  JAX's ``load_config``, flattened, key for key; the port's own keys are
  the same with and without them.
- ``diff_strength=abc`` raises JAX's ``ValueError``.
- Twins of the tests of ``tests/test_config.py`` that concern the port.
"""

import math

import numpy as np
import pytest

from zdcsim.config import _parse_override_value as jax_parse
from zdcsim.config import load_config as jax_load_config
from zdcsim_torch.config import load_config, parse_override_value, to_dict

OVERRIDES = [
    # the faults' table
    "yes", "on", "off", "No", "0x10", ".inf", "'abc'", "{a: 1}",
    # and the rest of the checklist
    "null", "None", "~", "[44,44]", "5e-5", "2312", "1.", "+3",
    # YAML 1.1's other scalar forms, flow collections, comments, not-YAML text
    "", "abc", "a b", "a #c", "a#c", "True", "FALSE", "y", "NO", "0", "-0", "017", "0b101",
    "0x_1F", "190:20:30", "1:30.5", "1_000", "1_000.5", "+.5", ".5", "5.", "1e5", "1.0e+5",
    "-.Inf", ".NaN", "nan", "inf", "Infinity", "1-6", "1e-5", "'5'", '"5e-5"', "'it''s'",
    '"a\\"b"', "2023-01-01", "2001-12-14t21:59:43.10-05:00", "2023-01-01 10:00:00",
    "[1, [2, 3]]", "{a: [1, 2]}", "{a}", "{a: }", "[1,]", "[1, 'a, b']", "[a b, c]",
    "{a: 1, b: {c: 2}}", "{1: a}", "[null, ~, true]", "{}", "[]", "[-1, +2]", "[a, -]",
    "{'a': 1}", "{a:1}", "[a:b]", "http://x", "-a", "?a", ":a", "[1]#c", "'abc' # c",
    "#c", "1e3.", "a, b",
    # PyYAML refuses these: JAX keeps the text
    "[1", "[,]", "]", "'a", "@x", "`x", "%x", "*a", "...", "[1]]", "[1] x", "'a' b", "[:a]",
    "[1 #c]", "=", "a\tb",
]
# valid YAML that the port does not read: it raises instead of differing
UNREAD = ["- 1", "-", "? a", "a: 1", "a:", "'a': 1", "&a 1", "!!str 1", "|", "---",
          '"a\\nb"', "[a: 1]", "{? a}", "<<", "a: b: c"]


def same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and repr(a) == repr(b)


@pytest.mark.parametrize("raw", OVERRIDES)
def test_override_value_parses_as_jax(raw):
    ours, ref = parse_override_value(raw), jax_parse(raw)
    assert same(ours, ref), (ours, ref)


@pytest.mark.parametrize("raw", UNREAD)
def test_yaml_the_port_does_not_read_raises(raw):
    jax_parse(raw)  # JAX reads it
    with pytest.raises(ValueError, match="override value"):
        parse_override_value(raw)


def flat(tree, prefix=""):
    if isinstance(tree, dict) and tree:
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: list(tree) if isinstance(tree, tuple) else tree}


def assert_equal_to_jax(ours_cfg, ref_cfg):
    """Every key of JAX's config is the port's, with an equal value of the
    same type; the port's keys beyond JAX's are those of the defaults."""
    ours, ref = flat(to_dict(ours_cfg)), flat(ref_cfg.to_dict())
    base_ours, base_ref = flat(to_dict(load_config())), flat(jax_load_config().to_dict())
    assert set(ours) - set(ref) == set(base_ours) - set(base_ref)
    bad = {k: (ours.get(k, "missing"), v) for k, v in ref.items()
           if k not in ours or not same(ours[k], v)}
    assert not bad, bad


OVERRIDE_SETS = {
    "legacy_and_bools": ["model.router.diff_strength=1-6", "wandb.log_experiments=off",
                         "train.remat=yes", "dataset.synthetic=on",
                         "model.generator.sdi_pairwise_quirk=No"],
    "scalars": ["dataset.MAX_INTENSITY_THRESHOLD=.inf", "train.seed=0x10",
                "config.run_name='abc'", "model.router.alb_strength=1e-5",
                "dataset.test_size=1.", "train.epochs=+3", "dataset.read_n_samples=~"],
    "jax_test": ["model.n_experts=5", "model.generator.lr_g=5e-5",
                 "dataset.input_image_shape=[44,44]", "train.checkpoint_experiment_dir=null",
                 "dataset.MAX_INTENSITY_THRESHOLD=2312"],
    "extra_keys": ["train.new_key=2", "extra={a: 1, b: [2, 3]}", "x.y.z=[1, 2]",
                   "model.router.new_knob=off", "extra.c=None", "x.y=5"],
    "strings_as_floats": ["model.router.gan_strength=5e-5", "model.router.ed_strength='1e-3'",
                          "model.router.util_strength=\"0\""],
}


@pytest.mark.parametrize("case", list(OVERRIDE_SETS))
def test_load_config_overrides_equal_jax(case):
    overrides = OVERRIDE_SETS[case]
    assert_equal_to_jax(load_config(overrides), jax_load_config(overrides=overrides))


YAML_FILES = {
    "legacy_strengths": ("model:\n  router:\n    diff_strength: 1-6\n    alb_strength: 1e-5\n"
                         "    gan_strength: '0.1'\n    util_strength: 2-3\n"),
    "yaml_bools": ("train:\n  remat: yes\n  fast_generator: On\nwandb:\n  log_experiments: off\n"
                   "  plot_images: NO\ndataset:\n  synthetic: true\n"),
    "extra_keys": ("model:\n  new_knob: 1\n  generator:\n    extra: [1, 2]\n"
                   "top_level: {a: 1, b: x, c: [0x10, .inf]}\nother:\n  deep:\n"
                   "    key: 2023-01-01\n    empty:\n  flag: off\nwandb:\n  project: p\n"),
    "scalars": ("dataset:\n  MAX_INTENSITY_THRESHOLD: 2312\n  input_image_shape: [44, 44]\n"
                "  zdc_type: neutron\nmodel:\n  architecture: neutron\n  norm: group\n"
                "train:\n  seed: 017\n  ws_threshold_model_save: .inf\n"
                "config:\n  run_name: 'quoted # name'\n"),
}


@pytest.mark.parametrize("name", list(YAML_FILES))
def test_load_config_yaml_files_equal_jax(name, tmp_path):
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAML_FILES[name])
    assert_equal_to_jax(load_config(config_path=str(path)), jax_load_config(str(path)))


def test_yaml_file_then_overrides_equal_jax(tmp_path):
    path = tmp_path / "user.yaml"
    path.write_text(YAML_FILES["extra_keys"] + "dataset:\n  synthetic: yes\n")
    overrides = ["other.deep.more=3", "model.new_knob=off", "top_level={z: 1}",
                 "model.router.diff_strength=2-5", "model.router.alb_strength=1e-5"]
    ours = load_config(overrides, config_path=str(path))
    assert_equal_to_jax(ours, jax_load_config(str(path), overrides))
    assert ours.other.deep.more == 3 and ours.model.new_knob is False
    assert ours.top_level.z == 1 and not hasattr(ours.top_level, "a")  # replaced, as JAX
    assert ours.model.router.diff_strength == pytest.approx(2e-5)
    assert ours.wandb.project == "p"


def test_unreadable_legacy_strength_raises_as_jax():
    with pytest.raises(ValueError, match="Cannot interpret router.diff_strength='abc'"):
        jax_load_config(overrides=["model.router.diff_strength=abc"])
    with pytest.raises(ValueError, match="Cannot interpret router.diff_strength='abc'"):
        load_config(["model.router.diff_strength=abc"])


def test_typed_keys_refuse_keys_and_mappings():
    """A key under a typed value, a mapping for a typed value and a value for
    a section of the defaults raise ``KeyError`` (JAX would replace them and
    fail later)."""
    for bad in ("train.batch_size.x=1", "train.batch_size={a: 1}", "model=3", "model={a: 1}"):
        with pytest.raises(KeyError, match="Config path not found"):
            load_config([bad])


# -- twins of tests/test_config.py -------------------------------------------


def test_default_config_loads():
    cfg = load_config()
    assert cfg.model.n_experts == 3
    assert cfg.model.noise_dim == 10
    assert cfg.model.cond_dim == 9
    assert tuple(cfg.dataset.input_image_shape) == (56, 30)
    assert cfg.train.batch_size == 512
    assert cfg.model.router.tau_start == pytest.approx(1.2)


def test_overrides_parse_yaml_scalars():
    cfg = load_config(OVERRIDE_SETS["jax_test"])
    assert cfg.model.n_experts == 5
    assert cfg.model.generator.lr_g == pytest.approx(5e-5)
    assert list(cfg.dataset.input_image_shape) == [44, 44]
    assert cfg.train.checkpoint_experiment_dir is None
    assert cfg.dataset.MAX_INTENSITY_THRESHOLD == 2312


def test_legacy_diff_strength_string_is_normalized():
    cfg = load_config(["model.router.diff_strength=1-6"])
    assert cfg.model.router.diff_strength == pytest.approx(1e-6)


def test_runtime_key_injection():
    cfg = load_config()
    cfg.photon_sum_min = 1.0
    cfg.data_cond_names = ["Energy", "Vx"]
    assert cfg.photon_sum_min == 1.0
    assert cfg.data_cond_names == ["Energy", "Vx"]
    assert to_dict(cfg)["data_cond_names"] == ["Energy", "Vx"]


def test_missing_key_raises():
    cfg = load_config()
    with pytest.raises(AttributeError):
        _ = cfg.model.not_a_key


def test_resume_flags_must_pair():
    with pytest.raises(ValueError):
        load_config(["train.epoch_to_load=10"])


def test_user_yaml_merge(tmp_path):
    p = tmp_path / "user.yaml"
    p.write_text("model:\n  n_experts: 7\ndataset:\n  zdc_type: neutron\n")
    cfg = load_config(config_path=str(p))
    assert cfg.model.n_experts == 7
    assert cfg.dataset.zdc_type == "neutron"
    assert cfg.model.noise_dim == 10


def test_io_roundtrip(tmp_path):
    from zdcsim_torch.utils import (
        load_scales, load_train_test_indices, save_scales, save_train_test_indices,
    )

    d = str(tmp_path)
    save_scales("proton", np.array([1.0, 2.0]), np.array([0.5, 0.25]), d)
    means, scales = load_scales("proton", d)
    assert means.tolist() == [1.0, 2.0]
    assert scales.tolist() == [0.5, 0.25]
    save_train_test_indices(d, np.arange(5), np.arange(5, 8))
    tr, te = load_train_test_indices(d)
    assert tr.tolist() == [0, 1, 2, 3, 4]
    assert te.tolist() == [5, 6, 7]
