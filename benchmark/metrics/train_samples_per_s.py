"""Batch x steps completed in the window over the window's whole time,
which ends in a synchronise (host clock)."""


def read(run):
    w = run.window
    return w["work"] / w["seconds"] if w.get("seconds") else None
