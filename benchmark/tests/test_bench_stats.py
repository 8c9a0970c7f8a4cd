"""The arithmetic of the readings: union of device intervals, percentiles over
all requests, the quartile spread, idle gaps."""

import statistics

import numpy as np
import pytest

from benchmark.harness import readings, stats


def test_union_counts_overlaps_once():
    # the stack's PDL launches overlap their predecessors
    iv = [(0, 10), (5, 12), (12, 13), (20, 25), (21, 22)]
    assert stats.union_length(iv) == 13 + 5
    assert stats.union_length([]) == 0
    assert stats.union_length([(3, 3)]) == 0
    # a sum would count 10 + 7 + 1 + 5 + 1
    assert sum(b - a for a, b in iv) == 24


def test_gaps_are_the_complement_of_the_union():
    iv = [(2, 4), (3, 6), (8, 9)]
    g = stats.gaps(iv, 0, 10)
    assert g == [(0, 2), (6, 8), (9, 10)]
    assert sum(b - a for a, b in g) + stats.union_length(iv) == 10


@pytest.mark.parametrize("n", [1, 2, 7, 100, 333])
@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_over_all_requests(n, q):
    xs = np.random.default_rng(n).lognormal(0, 1, n)
    assert stats.percentile(list(xs), q) == pytest.approx(float(np.percentile(xs, q)))


def test_request_p95_reads_every_request():
    lat = [0.1] * 94 + [0.2] * 6
    run = {"window": {"latencies_s": lat}}
    assert readings.request_ms(run, 95) == pytest.approx(1e3 * float(np.percentile(lat, 95)))


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_roofline_and_idle_readers():
    run = {"trace": {"busy_s": 0.75, "window_s": 1.0, "op_s": {"op": {0: 0.002, 1: 0.002}}},
           "op_counts": {"op": [(495e12 * 0.001, 0.0), (0.0, 3.35e12 * 0.0005)]},
           "window": {}}
    assert readings.idle_pct(run) == pytest.approx(25.0)
    # least times 1 ms and 0.5 ms over 4 ms measured
    assert readings.roofline_pct(run, "op") == pytest.approx(100 * 1.5 / 4)
    assert readings.roofline_pct(run, "other") is None
    assert readings.idle_pct({"trace": None}) is None


def test_mfu_reads_only_the_untraced_part_of_the_window():
    from benchmark.harness import peaks

    # 10 s traced at a lower rate, then 40 s untraced
    window = {"window_s": 50.0, "flops": 9e15, "untraced_s": 40.0, "untraced_flops": 8e15}
    mfu = readings.mfu_pct({"window": window})
    assert mfu == pytest.approx(100.0 * 8e15 / 40.0 / peaks.TF32_FLOPS)
    # the profiler's window alone gives no reading
    assert readings.mfu_pct({"window": dict(window, untraced_flops=0.0)}) is None


def test_a_dotted_metric_finds_the_reader_of_its_base_name():
    from benchmark.harness import manifest

    run = {"trace": {"busy_s": 9.0, "window_s": 10.0}}
    for name in ("idle_pct.b1", "idle_pct.batch", "idle_pct.train"):
        assert manifest.reader(name)(run) == pytest.approx(10.0)
