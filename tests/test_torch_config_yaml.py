"""The port's YAML-subset reader and config keys against PyYAML and the JAX
package's ``load_config``, on the CPU.

``zdcsim_torch.config.read_yaml`` reads what ``yaml.safe_load`` reads on
both committed configs and on small files of each construct they use
(nested maps, plain scalars of every YAML 1.1 resolver form held here,
quoted strings, flow lists and mappings, comments, keys without a value), and refuses
the constructs it does not read. ``load_config(config_path=...)`` equals
JAX's ``load_config(path)`` on every key of JAX's tree, flattened.
"""

import dataclasses
import os

import pytest
import yaml

from zdcsim.config import load_config as jax_load_config
from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config, read_yaml

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "zdcsim", "config")
FILES = ("default.yaml", "neutron.yaml")


@pytest.mark.parametrize("name", FILES)
def test_read_yaml_equals_safe_load_on_the_configs(name):
    path = os.path.join(CONFIGS, name)
    with open(path) as f:
        ref = yaml.safe_load(f)
    ours = read_yaml(path)
    assert ours == ref
    assert repr(ours) == repr(ref)  # the same types (1 against 1.0, True against "true")


CASES = {
    "scalars": ("a: 1\nb: -2\nc: 1.0e-4\nd: 5e-5\ne: .5\nf: 1_000\ng: 0\nh: +3\ni: 1.5E+3\n"
                "j: .inf\nk: -.Inf\n"),
    "null_and_bools": "a: null\nb: ~\nc: Null\nd: true\ne: False\nf: yes\ng: off\nh: TRUE\n",
    "strings": ("a: router_v1\nb: \"quoted # not a comment\"\nc: 'single ''q'''\n"
                "d: experiments/\ne: data/x.pkl\nf: 1-6\ng: \"a\\\\b \\\"c\\\"\"\n"),
    "nesting": ("top:\n  mid:\n    leaf: 1   # comment\n    other: x\n  back: 2\n"
                "# a whole-line comment\n\nnext: 3\nempty:\nlast: 4\n"),
    "flow_lists": "a: [56, 30]\nb: []\nc: [1.5, x, \"y, z\", null, true]\nd: [1, 2,]\n",
    "comments": "a: 1 # c\nb: x#y\nc: \"#\" # c\n",
    "deep_empty": "a:\n  b:\n  c: 1\nd:\n",
    "flow_collections": ("a: {b: 1, c: [2, [3]], 'd e': null}\nf: [1, [2, 3], {g: h}, []]\n"
                         "i: {}\nj: [0x10, 017, 1:30, .Inf, 2023-01-01] # c\nk: [1]#c\n"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_read_yaml_equals_safe_load_on_each_construct(case, tmp_path):
    path = tmp_path / f"{case}.yaml"
    path.write_text(CASES[case])
    ref = yaml.safe_load(CASES[case])
    ours = read_yaml(str(path))
    assert repr(ours) == repr(ref), (ours, ref)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: &x 1\n", "a: {b: 1\n", "a: |\n  text\n", "\ta: 1\n", "a: 1\n  b: 2\n",
    "a:\n    b: 1\n  c: 2\n", "a: 1\na: 2\n", "just text\n", "a: [1, [2]\n", "a: \"open\n",
    "---\na: 1\n", "a: \"\\n\"\n",
])
def test_read_yaml_refuses_what_it_does_not_read(text, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match="bad.yaml:"):
        read_yaml(str(path))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: list(tree) if isinstance(tree, tuple) else tree}


@pytest.mark.parametrize("name", [None, *FILES])
def test_load_config_equals_jax_on_every_key(name):
    """Every key of JAX's config (``default.yaml``, then the file merged
    over it) is one of the port's, with JAX's value; the 8 keys that the
    port lacked until its reader came are among them."""
    path = None if name is None else os.path.join(CONFIGS, name)
    ref = flat(jax_load_config(path).to_dict())
    ours = flat(dataclasses.asdict(load_config(config_path=path)))
    for key in ("dataset.DATA_IMAGES_PATH", "dataset.DATA_COND_PATH",
                "dataset.DATA_POSITIONS_PATH", "limit_samples", "model.router.version",
                "parallel.data_axis", "train.batch_size_aggregate", "wandb.api_key"):
        assert key in ref and key in ours, key
    assert {k: ours.get(k, "missing") for k in ref} == ref


def test_neutron_preset_file_equals_the_overrides():
    """``--config zdcsim/config/neutron.yaml`` and ``NEUTRON_OVERRIDES``
    give the same config but the data paths, which only the file sets."""
    a = dataclasses.asdict(load_config(config_path=os.path.join(CONFIGS, "neutron.yaml")))
    b = dataclasses.asdict(load_config(list(NEUTRON_OVERRIDES)))
    diff = {k for k, v in flat(a).items() if flat(b)[k] != v}
    assert diff == {"dataset.DATA_IMAGES_PATH", "dataset.DATA_COND_PATH",
                    "dataset.DATA_POSITIONS_PATH"}


def test_config_values_that_select_the_unported_raise(tmp_path):
    """``router_attention`` loads (the attention router is ported) and builds,
    equal to JAX's config; an unknown version raises as an override does;
    overrides apply after the file. A key that the defaults lack loads and
    reads back, as JAX's; a section of the defaults given a value raises."""
    from zdcsim_torch.models import build_moe

    path = tmp_path / "c.yaml"
    path.write_text("model:\n  router:\n    version: router_attention\n")
    cfg = load_config(config_path=str(path))
    assert cfg.model.router.version == jax_load_config(str(path)).model.router.version
    assert build_moe(cfg).names["router"] == "AttentionRouterNetwork"
    assert load_config(["model.router.version=router_v1"],
                       config_path=str(path)).model.router.version == "router_v1"
    path.write_text("model:\n  router:\n    version: router_v9\n")
    with pytest.raises(ValueError, match="router_v1"):
        load_config(config_path=str(path))
    path.write_text("model:\n  no_such_key: 1\n")
    assert load_config(config_path=str(path)).model.no_such_key == 1
    assert jax_load_config(str(path)).model.no_such_key == 1
    path.write_text("model: 3\n")
    with pytest.raises(KeyError, match="model"):
        load_config(config_path=str(path))
