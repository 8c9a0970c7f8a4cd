"""The training step's operations at each utterance's own length over the TF32
peak, per second of the window's untraced part (after the profiler stopped),
in %."""

from benchmark.harness import readings


def read(run):
    return readings.mfu_pct(run)
