"""The model's operations at each request's own length over the TF32 peak, per
second of the window's untraced part (after the profiler stopped), in %."""

from benchmark.harness import readings


def read(run):
    return readings.mfu_pct(run)
