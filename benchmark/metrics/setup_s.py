"""Process start to the first timed call: loading, making the weights,
building the program's kernels where the checkout has none yet, warming up
every shape of the window (host clock)."""


def read(run):
    return run.setup_s
