"""Weights and configuration carried across: the port's artifact reader,
``zdcsim_torch.convert`` and ``zdcsim_torch.config`` against the JAX
package's."""

import glob
import os

import numpy as np
import pytest
import torch

from zdcsim.config import load_config as jax_load_config
from zdcsim.utils.artifact import load_serving_artifact as jax_load
from zdcsim_torch.config import load_config
from zdcsim_torch.convert import expert, from_jax_params, from_state_dict, to_jax_params, to_state_dict
from zdcsim_torch.models.neutron import GeneratorNeutron
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.models.router import RouterNetwork
from zdcsim_torch.utils.artifact import _flatten, load_serving_artifact

ARTIFACTS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate",
                                          "*.npz")))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _assert_trees_bit_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


def test_all_artifacts_are_covered():
    assert len(ARTIFACTS) == 9


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_artifact_loads_bit_equal_and_round_trips(path):
    ours = load_serving_artifact(path)
    ref = jax_load(path)
    for a, b in zip(ours[:3], ref[:3]):
        _assert_trees_bit_equal(a, b)
    assert ours[3] == ref[3]
    del ref

    gen_params, _, router_params, meta = ours
    gen, router = from_jax_params(gen_params, router_params)
    assert all(t.dtype == torch.float32 for t in _flatten(gen).values())
    gen_back, router_back = to_jax_params(gen, router)
    _assert_trees_bit_equal(gen_back, gen_params)
    _assert_trees_bit_equal(router_back, router_params)

    n_experts = router_params["Dense_3"]["kernel"].shape[1]
    net = RouterNetwork(n_experts)
    net.load_state_dict(router)  # strict: every name and shape maps
    if "MLPBlock_1" in gen_params:  # the proton family
        module = Generator(width=float(meta.get("width", 1.0)))
    else:
        assert meta["family"] == "neutron"
        module = GeneratorNeutron(norm=meta["norm"], width=float(meta.get("width", 1.0)))
    module.load_state_dict(to_state_dict(expert(gen, 0)))
    _assert_trees_bit_equal(from_state_dict(module.state_dict()), expert(gen_params, 0))


def test_config_defaults_equal_jax_config():
    ours, ref = load_config(), jax_load_config()
    assert ours.model.architecture == ref.model.architecture
    assert ours.model.n_experts == ref.model.n_experts == 3
    assert ours.model.noise_dim == ref.model.noise_dim == 10
    assert ours.model.cond_dim == ref.model.cond_dim == 9
    assert ours.model.generator.width == ref.model.generator.width
    assert ours.model.generator.version == ref.model.generator.version == "v1"
    assert ours.model.norm == ref.model.norm == "batch"
    assert ours.dataset.zdc_type == ref.dataset.zdc_type
    assert list(ours.dataset.input_image_shape) == list(ref.dataset.input_image_shape) == [56, 30]
    # the keys the gate's data split reads
    for key in ("synthetic", "synthetic_n_samples", "MIN_INTENSITY_THRESHOLD",
                "MAX_INTENSITY_THRESHOLD", "read_n_samples", "shuffle_train_test_split",
                "test_size"):
        assert getattr(ours.dataset, key) == ref.dataset[key], key
    for key in ("seed", "batch_size", "save_experiment_data", "checkpoint_experiment_dir",
                "epoch_to_load"):
        assert getattr(ours.train, key) == ref.train[key], key
    assert ours.dataset.MIN_INTENSITY_THRESHOLD == 1


def test_config_train_step_keys_equal_jax_config():
    """The keys the train step reads (``zdcsim/train/step.py``,
    ``zdcsim/train/state.py``) have JAX's defaults."""
    ours, ref = load_config(), jax_load_config()
    for key in ("lr_g", "di_strength", "in_strength", "sdi_pairwise_quirk"):
        assert getattr(ours.model.generator, key) == ref.model.generator[key], key
    assert ours.model.discriminator.lr_d == ref.model.discriminator.lr_d
    for key in ("lr_a", "strength"):
        assert getattr(ours.model.aux_reg, key) == ref.model.aux_reg[key], key
    for key in ("lr_r", "ed_strength", "gan_strength", "diff_strength", "util_strength",
                "alb_strength", "stop_router_training_epoch", "alpha", "min_weight",
                "tau_start", "tau_min", "tau_decay", "differentiable_gan_term"):
        assert getattr(ours.model.router, key) == ref.model.router[key], key
    for key in ("ema_decay", "precision", "remat", "fast_generator", "dispatch",
                "dispatch_tile", "epochs", "stratified_batches"):
        assert getattr(ours.train, key) == ref.train[key], key


@pytest.mark.parametrize("extra", [[], ["model.norm=none", "model.generator.width=0.25"],
                                   ["model.generator.version=v2"]])
def test_config_neutron_preset_equals_jax(extra):
    """``NEUTRON_OVERRIDES`` (then the caller's overrides) against JAX's
    ``load_config("zdcsim/config/neutron.yaml")`` on the keys held here."""
    from zdcsim_torch.config import NEUTRON_OVERRIDES

    ours = load_config([*NEUTRON_OVERRIDES, *extra])
    ref = jax_load_config(os.path.join(os.path.dirname(__file__), "..", "zdcsim", "config",
                                       "neutron.yaml"), overrides=extra)
    for key in ("architecture", "n_experts", "noise_dim", "cond_dim", "norm"):
        assert getattr(ours.model, key) == ref.model[key], key
    for key in ("version", "width"):
        assert getattr(ours.model.generator, key) == ref.model.generator[key], key
    assert ours.dataset.zdc_type == ref.dataset.zdc_type == "neutron"
    assert list(ours.dataset.input_image_shape) == ref.dataset.input_image_shape == [44, 44]
    for key in ("synthetic", "synthetic_n_samples", "MIN_INTENSITY_THRESHOLD", "test_size"):
        assert getattr(ours.dataset, key) == ref.dataset[key], key


def test_config_checks_norm_and_generator_version():
    """``model.norm`` is batch, group or none; the (architecture, version)
    pair must name a generator, as ``build_moe`` requires."""
    with pytest.raises(ValueError, match="model.norm"):
        load_config(["model.norm=layer"])
    with pytest.raises(ValueError, match="no generator version"):
        load_config(["model.generator.version=v2"])  # proton has no v2
    assert load_config(["model.architecture=neutron",
                        "model.generator.version=v2"]).model.generator.version == "v2"


def test_config_router_widths_match_the_teacher_router():
    _, _, rp, _ = jax_load(ARTIFACTS[[os.path.basename(p) for p in ARTIFACTS]
                                     .index("gate_serving_weights.npz")])
    widths = tuple(rp[f"Dense_{i}"]["kernel"].shape[1] for i in range(3))
    assert load_config().model.router.widths == widths == (128, 64, 32)


@pytest.mark.parametrize("override", [
    "model.n_experts=5", "model.generator.width=0.25", "model.noise_dim=12",
    "dataset.input_image_shape=[44, 44]", "model.architecture=neutron",
    "dataset.synthetic=true", "dataset.synthetic_n_samples=25600", "train.seed=7",
    "train.batch_size=512", "dataset.MIN_INTENSITY_THRESHOLD=null", "dataset.test_size=0.25",
    "model.norm=none", "model.router.stop_router_training_epoch=null",
    "model.router.differentiable_gan_term=false", "model.generator.lr_g=2e-4",
    "train.dispatch=switch",
])
def test_config_overrides_parse_as_jax(override):
    ours = load_config([override])
    ref = jax_load_config(overrides=[override])
    key = override.split("=")[0]
    node_o, node_r = ours, ref
    for part in key.split("."):
        node_o, node_r = getattr(node_o, part), getattr(node_r, part)
    assert (list(node_o) if isinstance(node_o, tuple) else node_o) == node_r


def test_config_rejects_unknown_keys_and_bad_values():
    """A key that the defaults lack loads and reads back, as JAX's
    ``update_dotted`` makes it; a value for a section of the defaults and
    bad values raise."""
    assert load_config(["model.no_such_key=1"]).model.no_such_key == 1
    with pytest.raises(KeyError):
        load_config(["model.generator=1"])
    with pytest.raises(ValueError):
        load_config(["model.n_experts=0"])
    with pytest.raises(ValueError):
        load_config(["model.n_experts"])
