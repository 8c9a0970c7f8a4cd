"""The training kernels' least time (forward and backward) over their traced
device time, in %."""

from benchmark.harness import readings


def read(run):
    return readings.roofline_pct(run, "diffnet_train_fwd", "diffnet_train_bwd")
