"""The reader of the program's spans (``metrics/h2d_ms.py``) on spans
recorded by the program's tracer under a CPU profiler; None where there are
none."""

import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

import diffsinger_tpu_torch.utils
from benchmark.harness import manifest
from diffsinger_tpu_torch.utils import trace

# metric: (the span timed, the span it is divided by)
READS = {"h2d_ms.train": ("ds.train.h2d", "ds.train.step")}


def _record(timed: str, per: str, n: int) -> float:
    """``n`` spans ``per``, each holding two ``timed`` spans; returns their
    expected reading in ms."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(n):
            with trace.span(per, id=k):
                for _ in range(2):
                    with trace.span(timed):
                        time.sleep(0.001)
    recs = trace.spans()
    ms = sum(r.end_ns - r.start_ns for r in recs if r.name == timed) / 1e6
    return ms / sum(r.name == per for r in recs)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_the_spans(metric):
    timed, per = READS[metric]
    read = manifest.reader(metric)
    bench = manifest.load()
    entry = next(m for m in bench["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    try:
        want = _record(timed, per, 3)
        got = read({})
        assert got == pytest.approx(want) and got >= 2.0
        trace.clear()
        assert read({}) is None   # an untraced run: no spans
        # a span of another stage alone gives nothing to read
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("ds.other"):
                pass
        assert read({}) is None
    finally:
        trace.clear()


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_of_a_program_without_the_tracer_gives_none(metric, monkeypatch):
    """A program that has no ``utils/trace.py`` (a parent commit) reads None
    and does not raise; spans recorded here do not leak into that read."""
    try:
        _record(*READS[metric], 2)
        monkeypatch.delattr(diffsinger_tpu_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "diffsinger_tpu_torch.utils.trace", None)
        assert manifest.reader(metric)({}) is None
    finally:
        trace.clear()
