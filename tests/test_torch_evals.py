"""The eval figures of the port (``zdcsim_torch.evals.plots``,
``zdcsim_torch.train.eval_plots``, the loop's figures and the wandb hook)
against the JAX package's, on the CPU.

Each plot function draws on the same arrays as JAX's, and the figures'
data are equal: titles, image arrays, line data (the histograms' step
heights, the KDE curves), bar heights, scatter offsets. The device half of
``generate_eval_figures`` (routing, the routed generation in eval,
``expm1``) is held against JAX's ``router.apply`` / ``generator.apply`` on
the tiny modules (E=3) with JAX's noise passed in, on the tiled switch
path and the tile-1 gather; the whole ``generate_eval_figures`` against
JAX's on the same key. The tiny loop with ``train.save_eval_plots`` and
``wandb.plot_images`` writes the files JAX's writes and logs the figures as
``wandb.Image`` through a stub ``wandb`` module; without matplotlib it
raises before reading data; a fault of the device half propagates, one of
the host's drawing is logged and the run goes on.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")
pytest.importorskip("sklearn")

from zdcsim.config import load_config as jax_load_config  # noqa: E402
from zdcsim.evals import plots as jax_plots  # noqa: E402
from zdcsim.models.testing import build_tiny_moe as jax_build_tiny_moe  # noqa: E402
from zdcsim.train.eval_plots import generate_eval_figures as jax_generate  # noqa: E402
from zdcsim.train.state import init_state as jax_init_state  # noqa: E402
from zdcsim_torch.config import load_config  # noqa: E402
from zdcsim_torch.convert import train_state_from_jax  # noqa: E402
from zdcsim_torch.evals import plots  # noqa: E402
from zdcsim_torch.models.testing import build_tiny_moe  # noqa: E402
from zdcsim_torch.train import eval_plots  # noqa: E402

SHAPE = (8, 6)
E = 3
NAMES = ("Energy", "Vx", "Vy", "Vz", "Px", "Py", "Pz", "mass", "charge")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def figure_data(fig):
    """What a figure shows, as plain values and arrays."""
    out = [fig._suptitle.get_text() if fig._suptitle is not None else None]
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "yscale": ax.get_yscale(),
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "legend": [t.get_text() for t in legend.get_texts()] if legend else [],
            "images": [np.asarray(im.get_array()) for im in ax.images],
            "lines": [np.asarray(ln.get_xydata()) for ln in ax.lines],
            "bars": np.asarray([(p.get_x(), p.get_height()) for p in ax.patches]),
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
        })
    return out


def assert_same_figure(ours, ref, rtol=0.0):
    a, b = figure_data(ours), figure_data(ref)
    assert a[0] == b[0]
    assert len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        assert x.keys() == y.keys()
        for k in x:
            if k in ("images", "lines", "offsets"):
                assert len(x[k]) == len(y[k]), k
                for u, v in zip(x[k], y[k]):
                    np.testing.assert_allclose(u, v, rtol=rtol, atol=rtol, err_msg=k)
            elif k == "bars":
                np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=rtol, err_msg=k)
            else:
                assert x[k] == y[k], k


def plot_inputs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((n, 9)).astype(np.float32)
    cond[:, 8] = rng.integers(-1, 2, n)  # charge: categorical
    idx = rng.integers(0, E, n)
    real = rng.exponential(1.0, (n, *SHAPE)).astype(np.float32)
    gen = rng.exponential(1.0, (n, *SHAPE)).astype(np.float32)
    return cond, idx, real, gen


CALLS = {
    "real_vs_generated": lambda m, c, i, r, g: m.plot_real_vs_generated(r, g, 3, title="T"),
    "photonsum_histograms": lambda m, c, i, r, g: m.plot_photonsum_histograms_shared(
        [g[i == e].reshape((i == e).sum(), -1).sum(1) for e in range(E)]
        + [r.reshape(len(r), -1).sum(1)], labels=["Expert 0", "Expert 1", "Expert 2", "GEANT4"]),
    "expert_specialization": lambda m, c, i, r, g: m.plot_expert_specialization(c, i, 3, NAMES),
    "expert_heatmap": lambda m, c, i, r, g: m.plot_expert_heatmap(c, i, 3, NAMES),
    "cond_pca_tsne": lambda m, c, i, r, g: m.plot_cond_pca_tsne(c, i, 3),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_plot_equals_jax(name):
    args = plot_inputs()
    assert_same_figure(CALLS[name](plots, *args), CALLS[name](jax_plots, *args))


def test_histograms_refuse_as_jax():
    for bad in (([np.zeros(0)], None), ([np.ones(3)], ["a", "b"])):
        with pytest.raises(ValueError):
            plots.plot_photonsum_histograms_shared(*bad)


@pytest.fixture(scope="module")
def tiny():
    over = ["model.n_experts=3", f"dataset.input_image_shape=[{SHAPE[0]}, {SHAPE[1]}]"]
    cfg = jax_load_config(overrides=over)
    mods = jax_build_tiny_moe(cfg, SHAPE)
    state = jax_init_state(mods, cfg, jax.random.PRNGKey(0))
    return mods, state, build_tiny_moe(load_config(over), SHAPE), train_state_from_jax(state,
                                                                                        "cpu")


def eval_arrays(n):
    return {"real": jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (n, *SHAPE, 1))),
            "cond": jax.random.normal(jax.random.PRNGKey(2), (n, 9))}


@pytest.mark.parametrize("n", [32, 21])  # tile 32 (the switch path); tile 1 (the gather)
def test_device_half_equals_jax(tiny, n):
    mods, state, port_mods, port_state = tiny
    arrays = eval_arrays(n)
    key = jax.random.PRNGKey(5)
    cond, real = arrays["cond"], arrays["real"]
    _, logits = mods.router.apply({"params": state.router.params}, cond)
    idx = jnp.argmax(logits, axis=-1)
    noise = jax.random.normal(key, (n, mods.noise_dim))
    imgs = mods.generator.apply({"params": state.gen.params, **state.gen.stats}, noise, cond,
                                False)
    gen = jnp.take_along_axis(imgs, idx[None, :, None, None, None], axis=0)[0, ..., 0]
    ours = eval_plots.figure_arrays(port_mods, port_state,
                                    {k: np.array(v) for k, v in arrays.items()},
                                    noise=torch.from_numpy(np.array(noise)))
    assert len(np.unique(ours["experts"])) > 1
    np.testing.assert_array_equal(ours["experts"], np.asarray(idx))
    np.testing.assert_allclose(ours["generated"], np.asarray(jnp.expm1(gen)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ours["real"], np.asarray(jnp.expm1(real[..., 0])), rtol=1e-6)
    np.testing.assert_array_equal(ours["cond"], np.asarray(cond))


def test_generate_eval_figures_equals_jax(tiny):
    mods, state, port_mods, port_state = tiny
    arrays = eval_arrays(24)
    key = jax.random.PRNGKey(6)
    ref = jax_generate(mods, state, arrays, 4, list(NAMES), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (24, mods.noise_dim))))
    ours = eval_plots.generate_eval_figures(port_mods, port_state,
                                            {k: np.array(v) for k, v in arrays.items()}, 4,
                                            NAMES, noise=noise)
    assert list(ours) == list(ref)
    for name in ref:
        assert_same_figure(ours[name], ref[name], rtol=1e-4)


def test_figure_stream():
    from zdcsim_torch.utils.prng import eval_generator, figure_generator

    draw = lambda g: torch.randn(4, generator=g)  # noqa: E731
    assert torch.equal(draw(figure_generator(1, 2)), draw(figure_generator(1, 2)))
    assert not torch.equal(draw(figure_generator(1, 2)), draw(eval_generator(1, 2)))
    assert not torch.equal(draw(figure_generator(1, 2)), draw(figure_generator(1, 3)))


class _WandbStub:
    """A stand-in ``wandb`` module recording what a run logs."""

    def __init__(self):
        self.logged = []
        self.module = types.ModuleType("wandb")
        self.module.init = lambda **kw: self
        self.module.Image = lambda fig: ("Image", fig)

    def log(self, d):
        self.logged.append(d)

    def finish(self):
        pass


def loop_overrides(tmp_path, **over):
    """tests/test_torch_loop.py's tiny run (128 synthetic 8x6 events, batch
    32, E=2) with the figures on."""
    return ["dataset.synthetic=true", "dataset.synthetic_n_samples=128",
            "dataset.input_image_shape=[8, 6]", "train.batch_size=32", "model.n_experts=2",
            "train.eval_every=1", "train.epochs=1", "train.save_eval_plots=true",
            "wandb.plot_images=true", "wandb.log_experiments=true",
            f"train.save_experiments_dir={tmp_path}/", "parallel.n_devices=1",
            *[f"{k}={v}" for k, v in over.items()]]


def test_loop_writes_and_logs_the_figures_as_jax(tmp_path, monkeypatch):
    from zdcsim.train.loop import train as jax_train
    from zdcsim_torch.train.loop import train

    runs = {}
    for name, load, build, run in (
            ("jax", lambda o: jax_load_config(overrides=o), jax_build_tiny_moe,
             lambda cfg, m: jax_train(cfg, modules=m)),
            ("port", load_config, build_tiny_moe,
             lambda cfg, m: train(cfg, modules=m, device="cpu"))):
        stub = _WandbStub()
        monkeypatch.setitem(sys.modules, "wandb", stub.module)
        cfg = load(loop_overrides(tmp_path / name))
        run(cfg, build(cfg, SHAPE))
        runs[name] = (sorted(os.listdir(os.path.join(cfg.config.experiment_dir, "plots"))),
                      stub.logged)
    files, logged = runs["port"]
    assert files == runs["jax"][0]
    assert "real_vs_generated_epoch_0.png" in files and "cond_pca_tsne_epoch_0.png" in files
    figs = {k for k, v in logged[0].items() if isinstance(v, tuple) and v[0] == "Image"}
    ref = {k for k, v in runs["jax"][1][0].items() if isinstance(v, tuple) and v[0] == "Image"}
    assert figs == ref and len(figs) == 5


def test_loop_without_matplotlib_raises_before_reading_data(tmp_path, monkeypatch):
    import zdcsim_torch.train.loop as loop_mod

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(loop_mod, "get_train_test_data",
                        lambda cfg: pytest.fail("the loop read data before refusing"))
    for over in ({"wandb.plot_images": "false"}, {"train.save_eval_plots": "false"}):
        cfg = load_config(loop_overrides(tmp_path, **over))
        with pytest.raises(ImportError, match="matplotlib"):
            loop_mod.train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")


def test_loop_keeps_device_faults_and_logs_drawing_faults(tmp_path, monkeypatch, caplog):
    import zdcsim_torch.train.loop as loop_mod

    def device_fault(*a, **k):
        raise RuntimeError("device half failed")

    cfg = load_config(loop_overrides(tmp_path, **{"wandb.log_experiments": "false",
                                                  "config.run_name": "dev"}))
    with monkeypatch.context() as m:
        m.setattr(eval_plots, "routed_decode", device_fault)
        with pytest.raises(RuntimeError, match="device half failed"):
            loop_mod.train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")

    def drawing_fault(*a, **k):
        raise ValueError("drawing failed")

    cfg = load_config(loop_overrides(tmp_path, **{"wandb.log_experiments": "false",
                                                  "config.run_name": "host"}))
    monkeypatch.setattr(eval_plots, "build_figures", drawing_fault)
    history = loop_mod.train(cfg, modules=build_tiny_moe(cfg, SHAPE), device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]["ws_mean"])
    assert any("Eval figure generation failed" in r.getMessage() for r in caplog.records)
