"""The share of the lanes that the switch dispatch decoded which return no
shower: each expert's last tile padded with copies of its last row, the
unused chunks that the dyn form decodes into its dummy row, and the zero
rows that pad a call's last chunk. The program's counters
(``tiled_switch_decode.lanes``, ``FastSim.simulate_switch.showers``; a graph
replay counts what its capture held), over the window and the traced calls.
Nothing to read where the program has no such counters."""

from harness.spans import reset, serve_counters


def prepare(run):
    reset()
    for owner, attr in serve_counters() or ():
        setattr(owner, attr, 0)


def read(run):
    found = serve_counters()
    if found is None:
        return None
    lanes, showers = (getattr(o, a) for o, a in found)
    return 100.0 * (lanes - showers) / lanes if lanes > 0 else None
