"""``FastSim(mesh=...)``, the port's sharded serve, against the meshless
port and against the JAX package's sharded engine, on the CPU.

Two gloo worlds of 4 ranks, data 4 x expert 1 and data 2 x expert 2, each
spawned by a subprocess under a hard time limit, meeting through a
``file://`` store, one intra-op thread a rank. Every rank serves the
w=0.125 proton student (behind a router drawn from a seed, which reads
every expert) on 16 conditions in chunks of 8: ``simulate``,
``simulate_switch`` and ``simulate_bulk``, on ``f32`` and ``int8``, on the
JAX sharded engine's noise (``fold_in(key, start)`` per chunk), and on
noise drawn from an identically seeded generator (13 conditions: a padded
last chunk); ``simulate_grouped`` and ``simulate_stream``; a batch the data
axis does not divide; a state cut by ``shard_state`` (2 of its 4 experts
a rank on the 2 x 2 world).

Held: every rank returns the same results; ``f32`` routes as the meshless
port and within JAX's sharded-serving tolerance of it (rtol 1e-5, atol
1e-6, ``tests/test_parallel.py:131``), and within the port's engine
tolerance of JAX's sharded engine (log space, rtol / atol 2e-3,
``tests/test_torch_engine_api.py``); ``int8`` quantises a rank's rows on
their own scale, so it is held against JAX's sharded engine on the same
layout at the port's int8 bound and against the meshless port by JAX's int8
rule (per-shower log1p sums within rtol 0.1, ``tests/test_proton_fast.py:
269``); grouped and stream dispatch equal the meshless port's; the batch
raises JAX's ``ValueError``; the sharded state serves what the whole one
serves, bit for bit. Then ``python -m zdcsim_torch.parallel.dryrun --world 4
--cpu`` prints its OK line, its dense and switch train steps on the mesh
held against the meshless ones.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
STUDENT = os.path.join(REPO, "artifacts", "gate", "student_w0.125_serving_weights.npz")
N, BS, Z = 16, 8, 10
LAYOUTS = {"4x1": 1, "2x2": 2}  # name -> expert_parallel, in a world of 4
# seconds from its start: a world's subprocess is killed, ranks and all, after
# it (each takes 10-20 s alone; the limit is for a hang, with room for a loaded host)
WORLD_TIMEOUT = 150
PATHS = ("dense", "switch", "bulk")


class Launched:
    """A subprocess in a session of its own, started now and waited for
    later, killed with its children ``timeout`` seconds after its start."""

    def __init__(self, cmd, what, timeout=WORLD_TIMEOUT):
        self.what, self.deadline = what, time.monotonic() + timeout
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                                     text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     start_new_session=True)
        self.out = None

    def wait(self) -> str:
        if self.out is None:
            try:
                out, err = self.proc.communicate(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill()
                out, err = self.proc.communicate()
                pytest.fail(f"{self.what} ran over its time limit:\n{err[-3000:]}")
            assert self.proc.returncode == 0, out[-2000:] + err[-4000:]
            self.out = out
        return self.out

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)


def launch_world(fn_name, world, tmp, *args):
    """``fn_name`` of this module on ``world`` gloo ranks (one intra-op
    thread each; ``zdcsim_torch.parallel.dryrun.run_world``) with the store
    ``<tmp>/store``, launched in a subprocess."""
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"from zdcsim_torch.parallel.dryrun import run_world; "
            f"import {__name__.split('.')[-1]} as m; "
            f"run_world(m.{fn_name}, {world}, args={(str(tmp), *args)!r}, store_dir={str(tmp)!r})")
    return Launched([sys.executable, "-c", code], f"the world of {world} ranks in {tmp}")


def seeded_router(seed, widths=(9, 128, 64, 32), n_experts=3):
    """A router in the Flax layout from a seed (LeCun-normal kernels)."""
    rng = np.random.default_rng(seed)
    dims = [*widths, n_experts]
    return {f"Dense_{i}": {"kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                                      / np.sqrt(dims[i])).astype(np.float32),
                           "bias": np.zeros(dims[i + 1], np.float32)}
            for i in range(len(dims) - 1)}


# -- one rank ------------------------------------------------------------------

def _serve_rank(rank, world, dev, tmp, ep):
    """Every serve of the module doc on one rank; rank r writes its results
    to ``<tmp>/rank{r}.npz``."""
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.parallel.mesh import make_mesh
    from zdcsim_torch.utils.artifact import load_serving_artifact

    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        inp = dict(f)
    gp, _, _, meta = load_serving_artifact(STUDENT)
    router = seeded_router(40)
    cfg = load_config([f"model.generator.width={float(meta['width'])}"])
    mesh = make_mesh(expert_parallel=ep, device="cpu")
    out = {}
    for precision in ("f32", "int8"):
        kw = dict(batch_size=BS, precision=precision, cfg=cfg)
        eng = FastSim(gp, router, mesh=mesh, **kw)
        ref = FastSim(gp, router, device="cpu", **kw)
        noise = inp[f"noise_{precision}"]
        for path, fn in zip(PATHS, ("simulate", "simulate_switch", "simulate_bulk")):
            for tag, e in (("", eng), ("_meshless", ref)):
                imgs, ids = getattr(e, fn)(inp["cond"], noise=noise, return_experts=True)
                out[f"{precision}_{path}{tag}"], out[f"{precision}_{path}_ids{tag}"] = (
                    imgs.numpy(), ids.numpy())
        for tag, e in (("", eng), ("_meshless", ref)):
            imgs, ids = e.simulate_switch(inp["cond"][:13], return_experts=True,
                                          generator=torch.Generator().manual_seed(7))
            out[f"{precision}_drawn{tag}"], out[f"{precision}_drawn_ids{tag}"] = (
                imgs.numpy(), ids.numpy())
    eng = FastSim(gp, router, batch_size=BS, precision="f32", cfg=cfg, mesh=mesh)
    for fn in ("simulate_grouped", "simulate_stream"):  # the meshless port's: in the test
        out[fn] = getattr(eng, fn)(inp["cond"], noise=inp["noise_f32"]).numpy()
    bad = FastSim(gp, router, batch_size=BS - 1, precision="f32", cfg=cfg, mesh=mesh)
    for fn in ("simulate", "simulate_switch", "simulate_bulk"):
        try:
            getattr(bad, fn)(inp["cond"])
            out[f"error_{fn}"] = np.array("")
        except ValueError as e:
            out[f"error_{fn}"] = np.array(str(e))
    out.update(_sharded_state_serves(mesh, inp))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def _sharded_state_serves(mesh, inp):
    """A fresh width-0.125 proton state with E=4 served from this rank's
    ``shard_state`` piece and from the whole state, on the mesh."""
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.parallel.mesh import shard_state
    from zdcsim_torch.train.state import init_state

    cfg = load_config(["model.generator.width=0.125", "model.n_experts=4"])
    modules = build_moe(cfg)
    state = init_state(modules, cfg, 3, "cpu")
    local = shard_state(mesh, state, 4)
    out = {"state_local_rows": np.array(local.ema_gen_params["Conv_0.weight"].shape[0])}
    for tag, s in (("local", local), ("whole", state)):
        eng = FastSim.from_state(modules, s, cfg=cfg, batch_size=BS, mesh=mesh)
        imgs, ids = eng.simulate_switch(inp["cond"], noise=inp["noise_f32"], return_experts=True)
        out[f"state_{tag}"], out[f"state_{tag}_ids"] = imgs.numpy(), ids.numpy()
    return out


# -- the worlds and JAX's sharded engine ----------------------------------------

@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(11)
    cond = np.random.default_rng(7).standard_normal((N, 9)).astype(np.float32)

    def jax_noise(dtype):  # the JAX engine's per-chunk draws
        return np.concatenate([
            np.asarray(jax.random.normal(jax.random.fold_in(key, s), (BS, Z), dtype)
                       .astype(jnp.float32)) for s in range(0, N, BS)])

    return {"key": key, "cond": cond, "noise_f32": jax_noise(jnp.float32),
            "noise_int8": jax_noise(jnp.bfloat16)}


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """Both worlds of 4 and the dry run, started at once (the JAX engine
    and the meshless port run here meanwhile): ``{name: (Launched, tmp)}``."""
    out = {}
    for layout, ep in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(f"world_{layout}")
        np.savez(tmp / "inputs.npz", **{k: v for k, v in inputs.items() if k != "key"})
        out[layout] = launch_world("_serve_rank", 4, tmp, ep), tmp
    out["dryrun"] = Launched([sys.executable, "-m", "zdcsim_torch.parallel.dryrun", "--world",
                              "4", "--cpu"], "the dry run"), None
    yield out
    for proc, _ in out.values():
        proc.kill()


@pytest.fixture(scope="module", params=list(LAYOUTS))
def world(request, launched, jax_sharded, meshless):
    """``(layout, [rank results])`` of one world of 4."""
    layout = request.param
    proc, tmp = launched[layout]
    proc.wait()
    ranks = []
    for r in range(4):
        with np.load(tmp / f"rank{r}.npz") as f:
            ranks.append(dict(f))
    return layout, ranks


@pytest.fixture(scope="module")
def meshless(inputs):
    """The meshless port's grouped and stream serves, at two intra-op threads."""
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        gp, _, _, meta = load_serving_artifact(STUDENT)
        eng = FastSim(gp, seeded_router(40), batch_size=BS, precision="f32", device="cpu",
                      cfg=load_config([f"model.generator.width={float(meta['width'])}"]))
        return {fn: getattr(eng, fn)(inputs["cond"], noise=inputs["noise_f32"]).numpy()
                for fn in ("simulate_grouped", "simulate_stream")}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sharded(cpu_devices, inputs):
    """JAX's sharded engine's ``(images, ids)`` by (layout, precision, path)
    on 4 of the 8 virtual CPU devices; JAX's bulk program repeats its switch
    program's per-chunk keys (``engine.py:525``), so it is compiled once, on
    f32 at data 4 x expert 1."""
    from zdcsim.config import load_config as jax_config
    from zdcsim.inference import FastSim as JaxFastSim
    from zdcsim.models import build_moe
    from zdcsim.parallel.mesh import make_mesh
    from zdcsim_torch.utils.artifact import load_serving_artifact

    gp, _, _, meta = load_serving_artifact(STUDENT)
    modules = build_moe(jax_config(overrides=["model.n_experts=3",
                                              f"model.generator.width={float(meta['width'])}"]))
    out = {}
    for layout, ep in LAYOUTS.items():
        mesh = make_mesh(n_devices=4, expert_parallel=ep)
        for precision in ("f32", "int8"):
            eng = JaxFastSim(modules, gp, {}, seeded_router(40), batch_size=BS,
                             precision=precision, mesh=mesh)
            fns = {"switch": eng.simulate_switch}
            if precision == "f32":
                fns["dense"] = eng.simulate
                if layout == "4x1":
                    fns["bulk"] = eng.simulate_bulk
            for path, fn in fns.items():
                imgs, ids = fn(inputs["cond"], inputs["key"], return_experts=True)
                out[layout, precision, path] = np.asarray(imgs), np.asarray(ids)
    return out


def log1p_sums(imgs):
    return np.log1p(np.asarray(imgs, np.float64).sum(axis=(1, 2)))


# -- the checks --------------------------------------------------------------

def test_every_rank_returns_the_same(world):
    layout, ranks = world
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"{layout} {k}")
    assert ranks[0]["f32_switch"].shape == (N, 56, 30)
    assert ranks[0]["f32_drawn"].shape == (13, 56, 30)
    assert len(set(ranks[0]["f32_switch_ids"].tolist())) == 3  # every expert decodes


@pytest.mark.parametrize("path", PATHS + ("drawn",))
def test_f32_matches_the_meshless_port(world, path):
    layout, ranks = world
    r = ranks[0]
    np.testing.assert_array_equal(r[f"f32_{path}_ids"], r[f"f32_{path}_ids_meshless"])
    np.testing.assert_allclose(r[f"f32_{path}"], r[f"f32_{path}_meshless"], rtol=1e-5, atol=1e-6,
                               err_msg=f"{layout} {path}")


@pytest.mark.parametrize("path", PATHS)
def test_f32_matches_jax_sharded(world, jax_sharded, path):
    layout, ranks = world
    r = ranks[0]
    ref, ref_ids = jax_sharded.get((layout, "f32", path), jax_sharded[layout, "f32", "switch"])
    np.testing.assert_array_equal(r[f"f32_{path}_ids"], ref_ids)
    np.testing.assert_allclose(np.log1p(r[f"f32_{path}"]), np.log1p(ref), rtol=2e-3, atol=2e-3,
                               err_msg=f"{layout} {path}")


@pytest.mark.parametrize("path", PATHS + ("drawn",))
def test_int8_rule(world, jax_sharded, path):
    """Against the meshless port by JAX's int8 rule; the switch (and the
    bulk, its chunk loop on the CPU) also against JAX's sharded int8
    switch at the port's int8 bound."""
    layout, ranks = world
    r = ranks[0]
    imgs = r[f"int8_{path}"]
    assert np.isfinite(imgs).all() and imgs.min() >= 0
    np.testing.assert_array_equal(r[f"int8_{path}_ids"], r[f"int8_{path}_ids_meshless"])
    np.testing.assert_allclose(log1p_sums(imgs), log1p_sums(r[f"int8_{path}_meshless"]), rtol=0.1)
    if path in ("switch", "bulk"):
        ref, ref_ids = jax_sharded[layout, "int8", "switch"]
        np.testing.assert_array_equal(r[f"int8_{path}_ids"], ref_ids)
        log_out, log_ref = np.log1p(imgs), np.log1p(ref)
        assert np.abs(log_out - log_ref).max() < 0.05 * np.abs(log_ref).max() + 0.05


def test_grouped_and_stream_equal_the_meshless_port(world, meshless):
    _, ranks = world
    for fn in ("simulate_grouped", "simulate_stream"):
        np.testing.assert_array_equal(ranks[0][fn], meshless[fn])


def test_batch_not_divisible_raises(world):
    layout, ranks = world
    n_data = 4 // LAYOUTS[layout]
    for fn in ("simulate", "simulate_switch", "simulate_bulk"):
        msg = str(ranks[0][f"error_{fn}"])
        assert f"batch_size {BS - 1} must be divisible by the 'data' mesh axis size {n_data}" in msg


def test_sharded_state_served_equal(world):
    layout, ranks = world
    r = ranks[0]
    assert int(r["state_local_rows"]) == 4 // LAYOUTS[layout]  # a rank's share of 4 experts
    np.testing.assert_array_equal(r["state_local"], r["state_whole"])
    np.testing.assert_array_equal(r["state_local_ids"], r["state_whole_ids"])
    assert np.isfinite(r["state_local"]).all()


def test_dryrun_world_of_4_on_the_cpu(launched):
    out = launched["dryrun"][0].wait()
    line = [x for x in out.splitlines() if x.startswith("dryrun_multigpu OK")]
    assert len(line) == 1 and "mesh=(data=2, expert=2)" in line[0] and "served=64" in line[0]
    # its dense and switch train steps on the mesh, each held against the meshless one
    assert "trained=[dense gen_loss" in line[0] and ", switch gen_loss" in line[0]
    assert "on batch 16, each step held against the meshless one" in line[0]
