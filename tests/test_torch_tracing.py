"""The port's spans and counters (``zdcsim_torch/utils/profiling.py``), on the
CPU; one ``gpu``-marked test replays a real dyn graph on the card.

- Off (no profiler recording): ``span`` is one shared no-op and records
  nothing; the counters count all the same.
- On, under ``torch.profiler``: each span is a ``zdc.*`` event whose
  ``cpu_parent`` is the enclosing span; a warm span's host stamps lie within
  1 ms of its event's start and end on the profiler's clock
  (``trace_start_ns + time_range * 1000``, the ``time.time_ns()`` epoch).
- ``tiled_switch_decode.lanes`` against hand counts, eager and dyn;
  ``FastSim.simulate_switch.showers`` on the w=0.125 student.
- A profiled serve and a profiled dense step are bit-equal to unprofiled
  ones; the step's parts are recorded in order under ``train.step``; no
  span name holds ``conv`` (a per-layer reading keys on it in kernels'
  operator chains).
- The graph bookkeeping (a capture's counts taken back, added per replay)
  with a stand-in capture.

The card's test runs there without the repo's conftest (which imports JAX):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zdcsim_torch.config import load_config
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
from zdcsim_torch.models.testing import build_tiny_moe
from zdcsim_torch.train.state import init_state
from zdcsim_torch.train.step import build_train_step, draw_step_noise
from zdcsim_torch.utils import profiling
from zdcsim_torch.utils.artifact import load_serving_artifact

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "gate")
B = 8
STEP_PARTS = ["train.route", "train.disc", "train.gen", "train.router", "train.finish"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs beside other
    workers, among them the chip_smoke.py rehearsal under its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def profiled(fn):
    """``(fn()'s result, the profiler, the spans recorded)``."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, profiling.records()


def _decoders(e_count, out_shape):
    """Expert e multiplies (noise + cond-sum) by (e+1)."""
    return [lambda z, c, e=e: (e + 1.0) * (z.sum(1) + c.sum(1))[:, None, None]
            * torch.ones((1, *out_shape)) for e in range(e_count)]


def _decode_dyn(e_k, z, c):
    return (e_k.float() + 1.0) * (z.sum(1) + c.sum(1))[:, None, None] * torch.ones((1, 2, 2))


def _dispatch_inputs():
    """16 rows over 3 experts: 5 to expert 0, none to 1, 11 to 2."""
    idx = torch.tensor([0] * 5 + [2] * 11)[torch.randperm(16, generator=torch.Generator()
                                                          .manual_seed(0))]
    g = torch.Generator().manual_seed(1)
    return idx, torch.randn((16, 9), generator=g), torch.randn((16, 10), generator=g)


# ------ spans: off and on ------

def test_span_off_is_the_shared_no_op_and_counters_still_count():
    profiling.reset()
    a, b = profiling.span("serve.bulk"), profiling.span("train.step")
    assert a is b
    with a, b:
        pass
    idx, cond, noise = _dispatch_inputs()
    n0 = tiled_switch_decode.lanes
    tiled_switch_decode(_decoders(3, (2, 2)), idx, cond, noise, (2, 2), tile=4)
    assert profiling.records() == []
    assert tiled_switch_decode.lanes == n0 + 20


def test_spans_lie_on_the_profiler_timeline():
    def run():
        with profiling.span("warm"):
            pass
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()

    _, prof, recs = profiled(run)
    events = {e.name: e for e in prof.events() if e.name.startswith("zdc.")}
    assert set(events) == {"zdc.warm", "zdc.outer", "zdc.inner"}
    assert events["zdc.inner"].cpu_parent is events["zdc.outer"]
    assert events["zdc.outer"].cpu_parent is None
    assert [(r.name, r.parent) for r in recs] == [("warm", None), ("outer", None), ("inner", 1)]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for r in recs[1:]:
        ev = events["zdc." + r.name]
        assert abs(t0 + ev.time_range.start * 1000 - r.host_start_ns) < 1e6
        assert abs(t0 + ev.time_range.end * 1000 - r.host_end_ns) < 1e6
        assert r.host_start_ns <= r.host_end_ns and r.device_start_s is None


def test_reset_forgets_and_an_open_span_closes_after_it():
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        with profiling.span("a"):
            profiling.reset()
        with profiling.span("b"):
            pass
    assert [r.name for r in profiling.records()] == ["b"]


# ------ counters ------

def test_eager_dispatch_decodes_the_hand_counted_lanes():
    """Expert 0's 5 rows take 2 tiles of 4, expert 2's 11 rows 3: 20 lanes."""
    idx, cond, noise = _dispatch_inputs()
    n0 = tiled_switch_decode.lanes
    out = tiled_switch_decode(_decoders(3, (2, 2)), idx, cond, noise, (2, 2), tile=4)
    assert tiled_switch_decode.lanes - n0 == 20
    ref = (idx + 1.0) * (noise.sum(1) + cond.sum(1))
    torch.testing.assert_close(out[:, 0, 0], ref)


def test_dyn_dispatch_decodes_every_chunk():
    """The dyn form decodes all B/T + E chunks: (16/4 + 3) x 4 lanes."""
    idx, cond, noise = _dispatch_inputs()
    n0 = tiled_switch_decode.lanes
    tiled_switch_decode(_decoders(3, (2, 2)), idx, cond, noise, (2, 2), tile=4,
                        decode_dyn=_decode_dyn)
    assert tiled_switch_decode.lanes - n0 == (16 // 4 + 3) * 4


def test_graph_bookkeeping_with_a_stand_in_capture():
    """The counts made during a capture are taken back and stored; each
    replay adds them again."""
    owners = [tiled_switch_decode, _decode_dyn]
    _decode_dyn.launches = 5
    before = profiling.read_counts(owners, ("launches", "lanes"))
    assert set(before) == {(tiled_switch_decode, "lanes"), (_decode_dyn, "launches")}
    idx, cond, noise = _dispatch_inputs()
    # the stand-in capture: the dispatch runs, and a wrapper counts 7 launches
    tiled_switch_decode(_decoders(3, (2, 2)), idx, cond, noise, (2, 2), tile=4,
                        decode_dyn=_decode_dyn)
    _decode_dyn.launches += 7
    delta = profiling.take_counts(before)
    assert delta == {(tiled_switch_decode, "lanes"): 28, (_decode_dyn, "launches"): 7}
    assert profiling.read_counts(owners, ("launches", "lanes")) == before
    for _ in range(2):  # two replays
        profiling.add_counts(delta)
    assert tiled_switch_decode.lanes == before[(tiled_switch_decode, "lanes")] + 56
    assert _decode_dyn.launches == 5 + 14


# ------ the engine and the step ------

@pytest.fixture(scope="module")
def student():
    gp, _, _, meta = load_serving_artifact(os.path.join(ART, "student_w0.125_serving_weights.npz"))
    return gp, float(meta["width"])


def _router(seed=40):
    rng = np.random.default_rng(seed)
    dims = [9, 128, 64, 32, 3]
    return {f"Dense_{i}": {"kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                                      / np.sqrt(dims[i])).astype(np.float32),
                           "bias": np.zeros(dims[i + 1], np.float32)}
            for i in range(len(dims) - 1)}


def _engine(student, dyn, router=None):
    gp, width = student
    eng = FastSim(gp, router or _router(), batch_size=B, precision="int8", device="cpu",
                  cfg=load_config([f"model.generator.width={width}"]))
    eng._build_switch(tile=4, dyn_dispatch=dyn)
    return eng


def _serve_inputs(n=13):
    rng = np.random.default_rng(5)
    return rng.standard_normal((n, 9), dtype=np.float32), rng.standard_normal((n, 10),
                                                                             dtype=np.float32)


def test_engine_counts_showers_and_lanes(student):
    """13 rows in chunks of 8 (the last padded with 3 zero rows), every row
    to expert 1: 2 tiles of 4 a chunk, 16 lanes; 13 showers."""
    router = _router()
    router["Dense_3"]["bias"][1] = 1e3
    eng = _engine(student, dyn=False, router=router)
    cond, noise = _serve_inputs()
    s0, n0 = FastSim.simulate_switch.showers, tiled_switch_decode.lanes
    imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
    assert imgs.shape[0] == 13 and (ids == 1).all()
    assert FastSim.simulate_switch.showers - s0 == 13
    assert tiled_switch_decode.lanes - n0 == 16


@pytest.mark.parametrize("dyn", [False, True], ids=["eager", "dyn"])
def test_profiled_serve_is_bit_equal_and_spanned(student, dyn):
    eng = _engine(student, dyn)
    cond, noise = _serve_inputs()
    plain, plain_ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
    (imgs, ids), prof, recs = profiled(
        lambda: eng.simulate_bulk(cond, noise=noise, return_experts=True))
    assert torch.equal(imgs, plain) and torch.equal(ids, plain_ids)
    names = [r.name for r in recs]
    assert names[0] == "serve.bulk" and names.count("serve.bulk") == 1
    assert names.count("serve.chunk") == 2
    assert names.count("serve.route") == 2 and names.count("serve.table") == 2
    chunks = [i for i, n in enumerate(names) if n == "serve.chunk"]
    assert all(recs[i].parent == 0 for i in chunks)
    assert all(names[recs[i].parent] == "serve.chunk" for i, n in enumerate(names)
               if n in ("serve.route", "serve.table", "serve.decode"))
    n_decode = names.count("serve.decode")
    assert (n_decode == 2 * (8 // 4 + 3)) if dyn else (2 * 2 <= n_decode <= 2 * (8 // 4 + 3))
    assert sum(e.name == "zdc.serve.decode" for e in prof.events()) == n_decode


def _tiny_step(over=()):
    b = 16
    cfg = load_config(["model.n_experts=3", f"train.batch_size={b}", *over])
    mods = build_tiny_moe(cfg, (8, 6))
    step = build_train_step(mods, cfg)
    g = torch.Generator().manual_seed(1)
    batch = {"real": torch.randn((b, 8, 6, 1), generator=g).abs(),
             "cond": torch.randn((b, 9), generator=g),
             "std": torch.rand((b, 1), generator=g),
             "intensity": torch.rand((b, 1), generator=g) * 100,
             "positions": torch.rand((b, 2), generator=g) * 6}
    draws = draw_step_noise(torch.Generator().manual_seed(0), mods, b, "cpu", step.switch)
    return step, init_state(mods, cfg, 0, "cpu"), batch, draws


@pytest.mark.parametrize("over", [(), ("train.dispatch=switch", "train.dispatch_tile=4")],
                         ids=["dense", "switch"])
def test_step_records_its_parts_in_order(over):
    step, state, batch, draws = _tiny_step(over)
    plain, plain_m = step(state, batch, draws, 0)
    (new, metrics), _, recs = profiled(lambda: step(state, batch, draws, 0))
    assert [r.name for r in recs] == ["train.step", *STEP_PARTS]
    assert [r.parent for r in recs] == [None] + [0] * len(STEP_PARTS)
    assert all(a.host_end_ns <= b.host_start_ns for a, b in zip(recs[1:], recs[2:]))
    for name in ("gen", "disc", "aux", "router"):
        for k, v in getattr(plain, name).params.items():
            assert torch.equal(getattr(new, name).params[k], v), (name, k)
    assert all(torch.equal(new.ema_gen_params[k], v) for k, v in plain.ema_gen_params.items())
    assert all(torch.equal(metrics[k], v) for k, v in plain_m.items())


def test_no_span_name_holds_conv(student):
    eng = _engine(student, dyn=False)
    cond, noise = _serve_inputs()
    step, state, batch, draws = _tiny_step()
    _, prof, recs = profiled(lambda: (eng.simulate_bulk(cond, noise=noise),
                                      step(state, batch, draws, 0)))
    names = {r.name for r in recs}
    assert {"serve.bulk", "serve.decode", "train.step", *STEP_PARTS} <= names
    assert not any("conv" in e.name.lower() for e in prof.events() if e.name.startswith("zdc."))
    assert not any("conv" in n.lower() for n in names)


# ------ on the card ------

@pytest.mark.gpu
def test_dyn_graph_replays_count_as_the_eager_form():
    """A real dyn graph replayed: the wrappers' launches and the dispatch's
    lanes of the replays equal the eager dyn loop's on the same rows; the
    showers equal the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph replays there")
    from zdcsim_torch.ops import COUNTERS, kernel_wrappers

    gp, _, _, meta = load_serving_artifact(os.path.join(ART, "student_w0.125_serving_weights.npz"))
    eng = FastSim(gp, _router(), batch_size=128, precision="int8_pallas", device="cuda",
                  cfg=load_config([f"model.generator.width={float(meta['width'])}"]))
    eng._build_switch(tile=32, dyn_dispatch=True)
    owners = [*kernel_wrappers().values(), tiled_switch_decode]

    def counts():
        return profiling.read_counts(owners, (*COUNTERS, "lanes"))

    cond = np.random.default_rng(4).standard_normal((300, 9), dtype=np.float32)

    def gen():
        return torch.Generator(device="cuda").manual_seed(7)

    c0 = counts()
    eager = eng.simulate_switch(cond, generator=gen())
    c1 = counts()
    eng.simulate_bulk(cond, generator=gen())  # captures
    s0, c2 = FastSim.simulate_switch.showers, counts()
    again = eng.simulate_bulk(cond, generator=gen())
    c3 = counts()
    assert torch.equal(again, eager)
    eager_n = {k: c1[k] - c0[k] for k in c0}
    assert {k: c3[k] - c2[k] for k in c0} == eager_n
    assert eager_n[(tiled_switch_decode, "lanes")] == 3 * (128 // 32 + 3) * 32
    assert eager_n[(kernel_wrappers()["ln_leaky_rowquant"], "launches")] == 3 * (128 // 32 + 3)
    assert FastSim.simulate_switch.showers - s0 == 300
