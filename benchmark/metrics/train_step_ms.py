"""The window's wall time over its optimizer steps, in ms."""

from benchmark.harness import readings


def read(run):
    return readings.step_ms(run)
