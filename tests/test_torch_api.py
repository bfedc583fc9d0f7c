"""The port's public surface against the JAX package's, on the CPU.

- Every name that a ``zdcsim/**/__init__.py`` exports (read with ``ast``)
  imports from the matching port package, and every public top-level name
  of every ``zdcsim`` module has a twin in the port's matching module, but
  the names of :data:`BY_DESIGN`, each with the counterpart that takes its
  place.
- ``build_model`` for each of the nine names of ``MODEL_REGISTRY`` against
  JAX's ``build_model``: the same Flax fields as keyword specs, JAX's init
  tree (its constant leaves drawn from a seed) carried across by
  ``zdcsim_torch.convert``, the same numpy inputs, in eval, at the model
  tests' tolerances (the neutron modules 1e-4 as
  ``tests/test_torch_neutron.py``, the routers 1e-5 as
  ``tests/test_torch_router_attention.py``, the proton modules at width
  0.125 1e-4 as ``tests/test_torch_train_modules.py``).
- ``ExpertDense`` against JAX's at rtol 1e-5, with and without its bias.
- ``key_iterator``: one stream for a seed, its generators distinct.
"""

import ast
import dataclasses
import importlib
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.models import MODEL_REGISTRY as JAX_REGISTRY
from zdcsim.models import build_model as jax_build_model
from zdcsim.models.layers import ExpertDense as JaxExpertDense
from zdcsim_torch.convert import from_state_dict, to_state_dict
from zdcsim_torch.models import MODEL_REGISTRY, NEUTRON_SHAPE, PROTON_SHAPE, build_model
from zdcsim_torch.models.layers import ExpertDense
from zdcsim_torch.utils.prng import key_iterator, seeded_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "zdcsim")

# the JAX package's public names with no twin of the same name, and what takes their place
BY_DESIGN = {
    "zdcsim.config.ConfigNode": "zdcsim_torch.config.Config, a dataclass that keeps extra keys",
    "zdcsim.models.stack_experts": "zdcsim_torch.models.stack_trees + functional_call "
                                   "(MoEModules)",
    "zdcsim.train.state.init_state_jit": "zdcsim_torch.train.state.init_state",
    "zdcsim.utils.prng.split_tree": "explicit torch.Generator draws (zdcsim_torch.utils.prng)",
    "zdcsim.utils.prng.gumbel": "explicit torch.Generator draws (zdcsim_torch.ops.routing."
                                "gumbel_noise)",
    "zdcsim.utils.platform.force_cpu": "zdcsim_torch.device.default_device('cpu')",
    "zdcsim.utils.platform.enable_compile_cache": "zdcsim_torch.ops._build's hashed library "
                                                  "(no JAX compile cache)",
    "zdcsim.ops.pallas_decode_fused.FUSED_BLOCK_ROWS": "zdcsim_torch.ops.fused_decode_kernels."
                                                       "stage_plan (cluster plans)",
    "zdcsim.utils.profiling.StepTimer": "zdcsim_torch.train.loop's synchronised epoch time "
                                        "split, and zdcsim_torch.utils.profiling.span",
}
# JAX modules whose twin has another name (the Pallas kernels' ports, the config module)
MOVED = {
    "zdcsim.config": "zdcsim_torch.config",
    "zdcsim.ops.pallas_decode": "zdcsim_torch.ops.decode_kernels",
    "zdcsim.ops.pallas_decode_fused": "zdcsim_torch.ops.fused_decode_kernels",
    "zdcsim.ops.pallas_kernels": "zdcsim_torch.ops.epilogue_kernels",
    "zdcsim.utils.platform": "zdcsim_torch.device",
}
B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# public names
# ---------------------------------------------------------------------------


def public_names(path):
    """The public top-level names of a module file: its functions, classes
    and assignments, and in a package ``__init__`` the names it imports
    from ``zdcsim``."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.endswith("__init__.py")
              and (node.module or "").startswith("zdcsim")):
            names |= {a.asname or a.name for a in node.names}
    return sorted(n for n in names if not n.startswith("_") or n == "__version__")


def jax_modules(inits_only):
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if f.endswith(".py") and (f == "__init__.py" or not inits_only):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3].replace(os.sep, ".")
                out.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(out)


def port_twin(module):
    return MOVED.get(module, "zdcsim_torch" + module[len("zdcsim"):])


def missing_names(module):
    path = os.path.join(REPO, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    twin = importlib.import_module(port_twin(module))
    return [f"{module}.{n}" for n in public_names(path) if not hasattr(twin, n)]


@pytest.mark.parametrize("package", jax_modules(inits_only=True))
def test_every_package_export_imports_from_the_port(package):
    """``from zdcsim.X import name`` works as ``from zdcsim_torch.X import
    name`` for each name the package's ``__init__`` exports."""
    assert set(missing_names(package)) <= set(BY_DESIGN), missing_names(package)


def test_every_public_name_has_a_twin_but_the_named_ones():
    """Across every ``zdcsim`` module, exactly :data:`BY_DESIGN` has no twin."""
    missing = [n for m in jax_modules(inits_only=False) for n in missing_names(m)]
    assert sorted(missing) == sorted(BY_DESIGN)


def test_package_imports_and_version():
    import zdcsim
    import zdcsim_torch
    from zdcsim_torch.inference import FastSim
    from zdcsim_torch.ops import sum_channels
    from zdcsim_torch.train import build_train_step, train
    from zdcsim_torch.train.loop import train as loop_train
    from zdcsim_torch.train.step import build_train_step as step_build

    assert zdcsim_torch.__version__ == zdcsim.__version__
    assert train is loop_train and build_train_step is step_build
    assert FastSim.__module__ == "zdcsim_torch.inference.engine"
    assert sum_channels.__module__ == "zdcsim_torch.ops.channels"


# ---------------------------------------------------------------------------
# MODEL_REGISTRY / build_model
# ---------------------------------------------------------------------------

# the narrowest specs: the generators at width 0.125 (the rest have no width)
SPECS = {
    "proton.generator": {"noise_dim": 10, "cond_dim": 9, "width": 0.125},
    "proton.discriminator": {"cond_dim": 9},
    "proton.aux_reg": {"output_dim": 2},
    "neutron.generator": {"noise_dim": 10, "cond_dim": 9, "norm": "batch", "width": 0.125},
    "neutron.generator_v2": {"noise_dim": 10, "cond_dim": 9, "norm": "group", "width": 0.125},
    "neutron.discriminator": {"cond_dim": 9},
    "neutron.aux_reg": {"output_dim": 2, "norm": "batch"},
    "router_v1": {"n_experts": 3},
    "router_attention": {"n_experts": 3, "embed_dim": 64},
}
TOLERANCES = {"proton": dict(rtol=1e-4, atol=1e-5), "neutron": dict(rtol=1e-4, atol=1e-4),
              "router": dict(rtol=0, atol=1e-5)}


def test_registry_names_and_classes_are_jax_s():
    assert list(MODEL_REGISTRY) == list(JAX_REGISTRY)
    assert {k: v.__name__ for k, v in MODEL_REGISTRY.items()} == {
        k: v.__name__ for k, v in JAX_REGISTRY.items()}
    with pytest.raises(ValueError, match="Unknown model 'nope'"):
        build_model("nope", device="cpu")
    with pytest.raises(ValueError):
        jax_build_model("nope")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card")
def test_build_model_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("router_v1")
    assert next(build_model("router_v1", device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", list(JAX_REGISTRY))
def test_build_model_takes_the_flax_fields(name):
    """Every field of the Flax module is a keyword of the port's class, and
    ``build_model`` builds the class from JAX's specs."""
    fields = {f.name for f in dataclasses.fields(JAX_REGISTRY[name])} - {"parent", "name"}
    params = inspect.signature(MODEL_REGISTRY[name]).parameters
    assert fields <= set(params), fields - set(params)
    assert type(build_model(name, SPECS[name], device="cpu")) is MODEL_REGISTRY[name]
    assert isinstance(jax_build_model(name, SPECS[name]), JAX_REGISTRY[name])


def model_inputs(name, seed):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((B, 9)).astype(np.float32)
    if ".generator" in name:
        return rng.standard_normal((B, 10)).astype(np.float32), cond
    if name.startswith("router"):
        return (2 * cond,)
    shape = PROTON_SHAPE if name.startswith("proton") else NEUTRON_SHAPE
    img = rng.standard_normal((B, *shape, 1)).astype(np.float32)
    return (img, cond) if name.endswith("discriminator") else (img,)


def carried_variables(name, module, args, seed):
    """JAX's init with its constant leaves drawn from a seed (biases N(0,
    0.1), norm scales 1 + N(0, 0.1)), a generator's output bias raised by 0.5
    (its last ReLU passes pixels), BatchNorm running statistics drawn as
    ``tests/test_torch_neutron.py`` draws them; spectral norm's stats as
    initialised."""
    extra = () if name.startswith("router") else (False,)
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k}, *args, *extra))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) if path[-1].key in ("kernel", "expert_queries")
                         else np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                         ).astype(np.float32), v["params"])
    if ".generator" in name:
        last = max((k for k in params if k.startswith("Conv_")), key=lambda k: int(k[5:]))
        params[last]["bias"] = params[last]["bias"] + np.float32(0.5)
    stats = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    if not name.endswith("discriminator"):  # BatchNorm's running statistics
        stats = jax.tree_util.tree_map_with_path(
            lambda path, a: (0.3 * rng.standard_normal(a.shape) if path[-1].key == "mean"
                             else 0.5 + rng.random(a.shape)).astype(np.float32), stats)
    return params, stats


def flat_stats(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: torch.from_numpy(np.array(tree))}
    return {k2: v2 for k, v in tree.items() for k2, v2 in flat_stats(v, f"{prefix}{k}|").items()}


@pytest.mark.parametrize("name", list(JAX_REGISTRY))
def test_build_model_matches_jax_on_carried_weights(name):
    jmod = jax_build_model(name, SPECS[name])
    args = model_inputs(name, 1)
    params, stats = carried_variables(name, jmod, args, 2)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    extra = () if name.startswith("router") else (False,)
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, *extra))(variables, *map(jnp.asarray, args))

    ours = build_model(name, SPECS[name], device="cpu").eval()
    discriminator = name.endswith("discriminator")
    ours.load_state_dict(to_state_dict(params, None if discriminator else stats))  # strict
    t_args = tuple(map(torch.from_numpy, args))
    with torch.no_grad():
        out = ours(*t_args, flat_stats(stats), False)[:2] if discriminator else ours(*t_args)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    tol = TOLERANCES[name.split(".")[0].split("_")[0]]
    for o, r in zip(outs, refs, strict=True):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol, err_msg=name)
    if ".generator" in name:
        assert (np.asarray(ref) > 0).mean() > 0.02  # the ReLU leaves pixels to compare
    if name.startswith("router"):
        assert np.array_equal(out[1].argmax(-1).numpy(), np.asarray(ref[1]).argmax(-1))


# ---------------------------------------------------------------------------
# ExpertDense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bias", [True, False])
def test_expert_dense_matches_jax(use_bias):
    """JAX's tree carried across as it is (``[E, I, O]``, ``[E, 1, O]``),
    the output at rtol 1e-5 against JAX's and a per-expert matmul, and the
    tree read back bit for bit."""
    e, b, i, o = 3, 16, 24, 8
    x = np.random.default_rng(3).standard_normal((e, b, i)).astype(np.float32)
    jl = JaxExpertDense(n_experts=e, features=o, use_bias=use_bias)
    params = jl.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    if use_bias:
        params = {**params, "bias": np.random.default_rng(5).standard_normal((e, 1, o)).astype(
            np.float32)}
    ref = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))

    layer = ExpertDense(e, o, use_bias, in_features=i)
    layer.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (e, b, o)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    k = np.asarray(params["kernel"], np.float64)
    per_expert = np.stack([x[j] @ k[j] + (params["bias"][j, 0] if use_bias else 0)
                           for j in range(e)])
    np.testing.assert_allclose(out, per_expert, rtol=1e-5, atol=1e-6)
    back = from_state_dict(dict(layer.state_dict()))
    assert sorted(back) == sorted(params)
    for key in params:
        assert np.array_equal(back[key], np.asarray(params[key])), key


def test_expert_dense_initialises_as_flax():
    """Flax's ``lecun_normal(batch_axis=(0,))``: standard deviation
    ``1/sqrt(I)``, truncated at two of its normal's; zero biases."""
    e, i, o = 3, 256, 128
    layer = ExpertDense(e, o, in_features=i)
    ref = np.asarray(JaxExpertDense(n_experts=e, features=o).init(
        jax.random.PRNGKey(0), jnp.zeros((e, 1, i)))["params"]["kernel"])
    k = layer.kernel.detach().numpy()
    assert abs(k.std() * math.sqrt(i) - 1) < 0.02 and abs(ref.std() * math.sqrt(i) - 1) < 0.02
    bound = 2 / math.sqrt(i) / 0.87962566103423978
    assert np.abs(k).max() <= bound * (1 + 1e-6) and np.abs(ref).max() <= bound * (1 + 1e-6)
    assert not layer.bias.detach().numpy().any()


# ---------------------------------------------------------------------------
# key_iterator
# ---------------------------------------------------------------------------


def draws(stream, n):
    return [torch.rand(4, generator=next(stream)) for _ in range(n)]


def test_key_iterator_is_one_stream_of_distinct_generators():
    a, b = draws(key_iterator(7), 5), draws(key_iterator(7), 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len({tuple(x.tolist()) for x in a}) == 5
    assert not torch.equal(draws(key_iterator(8), 1)[0], a[0])
    first = next(key_iterator(7, device="cpu"))
    assert first.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=seeded_generator([7, 0])), a[0])
