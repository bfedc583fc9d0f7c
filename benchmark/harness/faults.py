"""Faults that a serving cell's timed path can have, planted where the
answers are produced: each takes a bulk call's ``(showers, expert ids)``
and the cell's dispatch tile, and returns them broken. The CPU tests plant
them under ``FastSim.simulate_bulk``; ``calibrate.py --faults`` reads them
on the card at the cell's own size."""

from __future__ import annotations


def scaled_tile(imgs, ids, tile):
    """One decoded tile's showers twice as bright: the first ``tile`` rows
    routed to expert 0."""
    rows = (ids == 0).nonzero()[:tile, 0]
    imgs = imgs.clone()
    imgs[rows] *= 2.0
    return imgs, ids


def swapped_in_expert(imgs, ids, tile):
    """The dispatch's scatter mixing up the rows of one expert: each row
    routed to expert 0 gets the next such row's shower."""
    rows = (ids == 0).nonzero()[:, 0]
    imgs = imgs.clone()
    imgs[rows] = imgs[rows.roll(-1)]
    return imgs, ids


def scaled_all(imgs, ids, tile):
    return imgs * 1.5, ids  # a dequantisation scale off by half


def rolled(imgs, ids, tile):
    return imgs.roll(1, dims=0), ids  # each shower handed to its neighbour's row


def other_expert(imgs, ids, tile):
    return imgs, (ids + 1) % 3  # an expert id altered


FAULTS = {f.__name__: f for f in (scaled_tile, swapped_in_expert, scaled_all, rolled,
                                  other_expert)}


def plant(fault, tile):
    """Break ``FastSim.simulate_bulk`` with ``fault``; returns a function
    that mends it."""
    from zdcsim_torch.inference.engine import FastSim

    sound = FastSim.simulate_bulk

    def broken(self, *args, **kwargs):
        return fault(*sound(self, *args, **kwargs), tile)

    FastSim.simulate_bulk = broken
    return lambda: setattr(FastSim, "simulate_bulk", sound)
