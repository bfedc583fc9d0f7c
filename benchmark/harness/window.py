"""The measured window, alike for every entry: ``fn()`` called again and
again until ``seconds`` have passed on the host clock, at most two calls in
flight on the card (an event recorded after each, the oldest waited for
once a third is queued), then a synchronise; the window's time is the
whole of it."""

from __future__ import annotations

import time
from typing import Callable

import torch


def window(run, fn: Callable[[], None], seconds: float) -> int:
    """Calls of ``fn`` until ``seconds`` have passed; returns their number
    and sets ``run.window``'s ``seconds`` and ``calls`` (the entry adds
    ``work``). Ends in a synchronise."""
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(run.device)
    t0 = run.start_window()
    done, pending = 0, []
    while True:
        fn()
        done += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(run.device)
    run.window = {"seconds": time.perf_counter() - t0, "calls": done}
    return done
