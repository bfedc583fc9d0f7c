"""The share of the float32 peak (TF32 is off in the step) that the trained
rate uses: the floating-point operations of one step of the configuration,
counted once by ``FlopCounterMode`` on the plain reference's step on the
meta device (``counts/train.py``), times the untraced window's steps per
second."""

from counts.peaks import F32_FLOPS_PER_S
from counts.train import dense_step_flops


def read(run):
    w = run.window
    if not w.get("seconds"):
        return None
    flops = dense_step_flops(run.settings, int(run.traffic["rows_per_call"]))
    return 100.0 * flops * w["calls"] / w["seconds"] / F32_FLOPS_PER_S
