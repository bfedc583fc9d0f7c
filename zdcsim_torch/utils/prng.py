"""Deterministic random streams of the training loop (counterpart of
``zdcsim/utils/prng.py``).

JAX folds the epoch and the batch into one key; here each (seed, epoch,
batch) seeds its own ``torch.Generator`` from ``np.random.SeedSequence``, so
a resumed run draws, at each (epoch, batch), what the uninterrupted run drew
there. The streams are not JAX's: the tests hand the port JAX's draws.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np
import torch

EVAL_OFFSET = 10_000_000  # the eval streams' epoch offset (zdcsim/train/loop.py:143)
FIGURE_OFFSET = 20_000_000  # the eval figures' epoch offset (zdcsim/train/loop.py:166)


def seeded_generator(entropy, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the first 64-bit word
    of ``np.random.SeedSequence(entropy)``."""
    word = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(word)


def key_iterator(seed: int, device: str | torch.device = "cpu") -> Iterator[torch.Generator]:
    """An endless stream of fresh generators from a base seed (JAX's
    ``key_iterator``): the ``i``-th seeded from ``SeedSequence([seed, i])``."""
    for i in itertools.count():
        yield seeded_generator([int(seed), i], device)


def fold_epoch_batch(seed: int, epoch: int, batch_idx: int,
                     device: str | torch.device = "cpu") -> torch.Generator:
    """The generator of one train step's draws: ``(seed, epoch, batch)``."""
    return seeded_generator([int(seed), int(epoch), int(batch_idx)], device)


def eval_generator(seed: int, epoch: int, device: str | torch.device = "cpu") -> torch.Generator:
    """The generator of one evaluation's draws: ``(seed, EVAL_OFFSET + epoch)``."""
    return seeded_generator([int(seed), EVAL_OFFSET + int(epoch)], device)


def figure_generator(seed: int, epoch: int, device: str | torch.device = "cpu") -> torch.Generator:
    """The generator of one epoch's eval figures: ``(seed, FIGURE_OFFSET + epoch)``."""
    return seeded_generator([int(seed), FIGURE_OFFSET + int(epoch)], device)
