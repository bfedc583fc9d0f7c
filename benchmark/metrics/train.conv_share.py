"""The share of the device's time in kernels that the convolution operators
launched, forward and backward (cuDNN's fprop, dgrad and wgrad and their
layout transforms), in the traced steps."""


def read(run):
    t = run.trace
    conv = None if t is None else t.launched_by(lambda op: "conv" in op.lower())
    if conv is None or t.device_s <= 0:
        return None
    return 100.0 * conv / t.device_s
