"""The 95th percentile of every request's latency in the window, in ms."""

from benchmark.harness import readings


def read(run):
    return readings.request_ms(run, 95)
