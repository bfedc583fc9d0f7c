"""The share of the train step's device time in the discriminator update
(its generator fakes included): the time between the CUDA events of the
program's ``train.disc`` spans over that of its ``train.step`` spans, in
the traced steps (host time on a CPU run).
Nothing to read where the program records no such spans."""

from harness.spans import reset, span_share


def prepare(run):
    reset()


def read(run):
    return span_share(run, "train.disc", "train.step")
