"""The share of the chip's peaks that the served rate uses: the seconds that
one shower's routed decode needs at the peak of each layer's dtype
(``counts/decode.py``), times the untraced window's showers per second."""

from counts.decode import ideal_s_per_shower


def read(run):
    w = run.window
    if not w.get("seconds"):
        return None
    return 100.0 * ideal_s_per_shower(run.settings, run.cell["precision"]) * w["work"] / w["seconds"]
