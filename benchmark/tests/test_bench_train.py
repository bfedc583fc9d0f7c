"""The training cell on the CPU at width 0.125, batch 8: the port's dense step
against the plain reference's (the run comes out correct, its numbers at
float32 rounding); the controls and faults come out not correct: the
reference with TF32 on stands in only on the card (the CPU has no TF32),
so here the faults: a step that returns its state unchanged, half of each
batch left out with the mean taken over the rest, and faults that begin
only after the checked steps, which the window's last step shows."""

from __future__ import annotations

from dataclasses import replace

import pytest
import torch
from conftest import run_cpu

from zdcsim_torch.train import step as port_step


@pytest.fixture(scope="module")
def sound(tiny):
    spec, _ = tiny
    return run_cpu(spec, "tiny_proton_train", seed=31, seconds=0.1)


def test_sound_run_is_correct(sound):
    assert sound.result["correct"] is True, sound.checks
    values = {n: v for n, v, _ in sound.checks}
    assert values["loss_gap"] < 1e-4 and values["grad_gap"] < 1e-3
    assert values["last_loss_gap"] < 1e-4 and values["last_grad_gap"] < 1e-2
    assert sound.result["attempted"] >= 1


@pytest.mark.parametrize("control", ["unchanged", "half_batch"])
def test_fault_stands_in_and_fails(sound, control):
    entry = sound.spec.module("entries", "train_step")
    bad, checks = entry.check(sound, *sound.extra["check_inputs"], control=control)
    assert bad == 1, checks


def test_planted_fault_in_the_program_fails(tiny, monkeypatch):
    """The port's step broken underneath: it returns the state it was given."""
    spec, _ = tiny
    build = port_step.build_train_step

    def broken(*args, **kwargs):
        step = build(*args, **kwargs)

        def unchanged(state, batch, draws, epoch):
            _, metrics = step(state, batch, draws, epoch)
            return state, metrics

        return unchanged

    monkeypatch.setattr(port_step, "build_train_step", broken)
    run = run_cpu(spec, "tiny_proton_train", seed=32, seconds=0.1)
    assert run.result["correct"] is False


def _after_checked_steps(fault):
    """The port's step, sound for the checked steps, then broken by
    ``fault(state before, state after) -> state``."""
    build = port_step.build_train_step

    def broken(*args, **kwargs):
        step, calls = build(*args, **kwargs), [0]

        def late(state, batch, draws, epoch):
            new, metrics = step(state, batch, draws, epoch)
            calls[0] += 1
            return (new if calls[0] <= 3 else fault(state, new)), metrics

        return late

    return broken


@pytest.mark.parametrize("fault", [
    lambda old, new: old,  # the state stops moving
    lambda old, new: replace(new, ema_gen_params=old.ema_gen_params),  # the EMA stops
    lambda old, new: replace(new, gen=replace(new.gen, opt_state=replace(
        new.gen.opt_state, count=old.gen.opt_state.count))),  # Adam's count stops
], ids=["unchanged", "ema_frozen", "count_frozen"])
def test_fault_after_the_checked_steps_fails(tiny, monkeypatch, fault):
    spec, _ = tiny
    monkeypatch.setattr(port_step, "build_train_step", _after_checked_steps(fault))
    # a window of two steps or more: a count that stops shows in the next step
    run = run_cpu(spec, "tiny_proton_train", seed=33, seconds=2.0)
    assert run.attempted >= 2
    values = {n: (v, lim) for n, v, lim in run.checks}
    assert all(v <= lim for n, (v, lim) in values.items() if not n.startswith("last_"))
    assert run.result["correct"] is False, values


def test_flops_of_one_conv_layer_by_hand(tiny):
    """The count at batch 8 holds the generator's Conv_1 forward by hand:
    2 x 55 x 29 outputs x 4 x 4 x 256 x 128 per row, every expert, every row."""
    from torch.utils.flop_counter import FlopCounterMode

    from counts.train import dense_step_flops
    from reference.common import conv

    spec, _ = tiny
    s = spec.config("tiny_proton")["settings"]
    full = {**s, "model.generator.width": 1.0}
    by_hand = 2 * 8 * 55 * 29 * 4 * 4 * 256 * 128
    x = torch.empty(8, 56, 30, 256, device="meta")
    k, b = torch.empty(4, 4, 256, 128, device="meta"), torch.empty(128, device="meta")
    with FlopCounterMode(display=False) as counter:
        conv(x, k, b, (1, 1, 1, 1))
    assert counter.get_total_flops() == by_hand
    total = dense_step_flops(full, 8)
    # every expert's Conv_1 runs forward 3 times a step (the D phase's fakes and
    # two G-phase noises), its backward twice (input and kernel) for 2 of them
    assert total > 3 * 3 * by_hand
    assert dense_step_flops(full, 16) > 1.9 * total
