"""Traced wall time in which no operation ran on the device, in %."""

from benchmark.harness import readings


def read(run):
    return readings.idle_pct(run)
