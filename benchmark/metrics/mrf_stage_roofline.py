"""The MRF kernel's least time over its traced device time, in %."""

from benchmark.harness import readings


def read(run):
    return readings.roofline_pct(run, "mrf_stage")
