"""The share of the train step's device time in the generator and aux
update: the time between the CUDA events of the program's ``train.gen``
spans over that of its ``train.step`` spans, in the traced steps (host
time on a CPU run).
Nothing to read where the program records no such spans."""

from harness.spans import reset, span_share


def prepare(run):
    reset()


def read(run):
    return span_share(run, "train.gen", "train.step")
