"""Spans inside the program, on the profiler's clock.

A span names a stage of the program around the host work that issues it::

    with trace.span("ds.sampler.step", id=i):
        ...

The tracer is on exactly while a ``torch.profiler`` records in this process
(``torch.autograd.profiler._is_profiler_enabled``); it has no other switch.
Run any entry point under ``torch.profiler.profile`` (or set the trainer's
``profile_dir``) to get the spans.

* Off, ``span`` reads that flag and returns one shared object that does
  nothing: no clock read, no ``record_function``, no allocation.
* On, each span runs inside ``torch.profiler.record_function(name)``, so it
  is a range of the same profile as the device's kernels, and is recorded in
  memory as a :class:`Span`, up to ``LIMIT`` of them (later ones still get
  their range).

Both stamps are ``time.time_ns()``, the clock kineto stamps host events
with, taken just outside the range: a span in memory and its range in the
profile share one clock (within half a millisecond over a 10 s profile on
an H100 host), and the profile puts the device's intervals on the same
timeline, so an idle gap of the device can be put down to the span the host
was in. Kineto's device stamps can stray a few ms from its host stamps.

Every name starts with ``ds.`` (the profile's aten ops have none, and a
benchmark's own ranges another prefix). ``parent`` is the index in
:func:`spans` of the span open on the same thread when this one began: each
thread keeps its own stack.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler

LIMIT = 1_000_000   # spans kept in memory: a long traced window of any path


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]      # index in spans() of the enclosing span, same thread
    thread: int                # threading.get_ident() of the thread that ran it
    start_ns: int              # time.time_ns()
    end_ns: Optional[int]      # None while the span is open


class _Off:
    """What ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Open:
    """One span while it is open."""

    __slots__ = ("tracer", "name", "id", "index", "records", "start_ns", "range")

    def __init__(self, tracer: "Tracer", name: str, id: Optional[int]):
        self.tracer, self.name, self.id = tracer, name, id

    def __enter__(self):
        t = self.tracer
        stack = t._stack()
        parent = stack[-1].index if stack else None
        self.range = _profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self.range.__enter__()
        with t._lock:
            self.records = t._records
            if len(self.records) < t.limit:
                self.index = len(self.records)
                self.records.append(Span(self.name, self.id, parent, threading.get_ident(),
                                         self.start_ns, None))
            else:
                self.index = None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        self.tracer._stack().pop()
        if self.index is not None:   # the list it was opened in, even after a clear()
            self.records[self.index] = self.records[self.index]._replace(end_ns=end_ns)
        return None


class Tracer:
    """Spans of every thread of the process, in the order they began."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self._records: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, id: Optional[int] = None):
        """A context manager: the span ``name`` (``id``: the step of a loop,
        where it has one) while a profiler records, else nothing."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, id)

    def spans(self) -> Tuple[Span, ...]:
        return tuple(self._records)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name, over its closed spans: ``count`` and ``total_ms``."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.spans():
            if r.end_ns is None:
                continue
            s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += (r.end_ns - r.start_ns) / 1e6
        return out

    def clear(self) -> None:
        with self._lock:
            self._records = []


# the process's tracer
_TRACER = Tracer()
span = _TRACER.span
spans = _TRACER.spans
summary = _TRACER.summary
clear = _TRACER.clear
