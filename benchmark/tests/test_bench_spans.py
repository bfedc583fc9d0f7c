"""The readers of the program's own spans and counters on the CPU, through the
runner's traced path at the tiny size: ``serve.pad_share`` against the hand
count, ``train.disc_share`` and ``train.gen_share`` against the step's span
records; each reads nothing where the program has no such span or counter
(a parent without them)."""

from __future__ import annotations

import pytest
from conftest import run_cpu

from harness import spans
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
from zdcsim_torch.utils import profiling

NEW = {"serve.pad_share", "train.disc_share", "train.gen_share"}


@pytest.fixture(scope="module")
def neutron(tiny):
    spec, _ = tiny
    return run_cpu(spec, "tiny_neutron_serve", seed=41, trace=1)


@pytest.fixture(scope="module")
def train(tiny):
    spec, _ = tiny
    return run_cpu(spec, "tiny_proton_train", seed=42, seconds=0.1, trace=1)


def test_pad_share_of_the_dyn_form_is_the_hand_count(neutron):
    """The dyn form decodes all 16/4 + 3 chunks of 4 lanes for 16 showers a
    call: 12 of 28 lanes padded."""
    m = neutron.result["metrics"]
    assert m["serve.pad_share"]["value"] == pytest.approx(100 * 12 / 28, rel=1e-12)
    assert NEW & set(m) == {"serve.pad_share"}


def test_pad_share_of_the_eager_form_counts_window_and_trace(tiny):
    """The counters cover the window and the traced calls; each call pads
    each expert's last tile, at most 3 lanes an expert."""
    spec, _ = tiny
    run = run_cpu(spec, "tiny_proton_serve", seed=43, trace=1)
    showers, lanes = FastSim.simulate_switch.showers, tiled_switch_decode.lanes
    calls = showers // 16
    assert showers == run.attempted + run.trace_work and lanes % 4 == 0
    assert showers <= lanes <= showers + 3 * 3 * calls
    assert run.result["metrics"]["serve.pad_share"]["value"] == pytest.approx(
        100 * (lanes - showers) / lanes, rel=1e-12)


def test_step_shares_are_the_span_records(train):
    m = train.result["metrics"]
    assert NEW & set(m) == {"train.disc_share", "train.gen_share"}
    recs = profiling.records()
    assert [r.name for r in recs if r.parent is None] == ["train.step"]  # one traced step

    def host(name):
        return sum(r.host_end_ns - r.host_start_ns for r in recs if r.name == name)

    step = host("train.step")
    for part in ("disc", "gen"):
        assert m[f"train.{part}_share"]["value"] == pytest.approx(
            100 * host(f"train.{part}") / step, rel=1e-9)
    assert 0 < m["train.disc_share"]["value"] + m["train.gen_share"]["value"] <= 100


def test_readers_find_nothing_in_a_program_without_them(tiny, train, monkeypatch):
    """The parent program: no counters, no span records; the readers'
    set-up and reads raise nothing and read nothing."""
    spec, _ = tiny
    monkeypatch.delattr(FastSim.simulate_switch, "showers")
    monkeypatch.delattr(profiling, "records")
    assert spans.serve_counters() is None and spans.records() is None
    for name in ("serve.pad_share", "train.disc_share", "train.gen_share"):
        reader = spec.module("metrics", name)
        reader.prepare(train)
        assert reader.read(train) is None


def test_step_share_by_device_events_or_on_the_cpu_by_host_time(monkeypatch):
    """Device time between the spans' events; host time only where the run
    is on the CPU; nothing on the card from spans without events."""
    import torch

    rec = profiling.SpanRecord
    on_host = [rec("train.step", None, 0, 10, None, None), rec("train.disc", 0, 1, 3, None, None)]
    on_card = [rec("train.step", None, 0, 10, 1.0, 2.0), rec("train.disc", 0, 1, 3, 1.1, 1.35)]

    class Run:
        device = torch.device("cpu")

    monkeypatch.setattr(spans, "records", lambda: on_host)
    assert spans.span_share(Run, "train.disc", "train.step") == pytest.approx(20.0)
    Run.device = torch.device("cuda")
    assert spans.span_share(Run, "train.disc", "train.step") is None
    monkeypatch.setattr(spans, "records", lambda: on_card)
    assert spans.span_share(Run, "train.disc", "train.step") == pytest.approx(25.0)
    assert spans.span_share(Run, "train.gen", "train.step") is None
