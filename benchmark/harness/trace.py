"""The traced run's readings: the device's busy time (the union of its
intervals), each kernel op's time per call, the device operations that took
most time and the longest idle gaps, from ``torch.profiler``.

An op's time is the union of the device intervals of everything launched
while its Python entry ran: the entry is wrapped in a ``record_function``
range, and each device event is tied to the host call that launched it by
CUPTI's correlation id. It does not depend on kernel names, so a later
change that swaps the kernels inside an op keeps the reading.
"""

from __future__ import annotations

import bisect
import functools
from typing import Any, Callable, Dict, List, Tuple

import torch

from .stats import gaps, union_length

OP_PREFIX = "bench.op."


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in _tensors(a)]
    return []


def nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor or nested tuples)."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class OpCalls:
    """Wraps a program op's entry: while ``active``, each call runs inside a
    ``record_function`` range named after the op and the call's number, and
    ``count(args, kwargs, result)`` records its operations and bytes."""

    def __init__(self, module, attr: str, count: Callable[..., Tuple[float, float]]):
        self.module, self.attr, self.count = module, attr, count
        self.orig = getattr(module, attr)
        self.active = False
        self.calls: List[Tuple[float, float]] = []   # (operations, bytes) by call number

        @functools.wraps(self.orig)
        def wrapper(*args, **kwargs):
            if not self.active:
                return self.orig(*args, **kwargs)
            i = len(self.calls)
            self.calls.append(None)
            with torch.profiler.record_function(f"{OP_PREFIX}{attr}#{i}"):
                out = self.orig(*args, **kwargs)
            self.calls[i] = self.count(args, kwargs, out)
            return out

        self.wrapper = wrapper
        setattr(module, attr, wrapper)

    def restore(self) -> None:
        """Put the entry back, with what the program recorded on it while it
        was wrapped (its body updates the module's name: the wrapper)."""
        for k in vars(self.orig):
            if k != "__wrapped__" and hasattr(self.wrapper, k):
                setattr(self.orig, k, getattr(self.wrapper, k))
        setattr(self.module, self.attr, self.orig)


def _kind(e) -> str:
    """The event's kind: ``kernel`` (any device operation),
    ``gpu_user_annotation``, ``user_annotation``, ``cuda_runtime`` or
    ``cpu_op``, from ``activity_type`` where this PyTorch has it."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind())
        return "kernel" if kind in ("gpu_memcpy", "gpu_memset") else kind
    annotation = bool(getattr(e, "is_user_annotation", lambda: False)()) or \
        e.name().startswith("bench.")
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith(("cuda", "cu")) else "cpu_op"


WINDOW = "bench.window"


def read(prof) -> Dict[str, Any]:
    """Readings of a finished profile whose traced window ran inside a
    ``record_function(WINDOW)`` range."""
    events = prof.profiler.kineto_results.events()
    device, launch_at, ranges, host, window = [], {}, [], [], None
    kinds: Dict[str, int] = {}
    for e in events:
        kind = _kind(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        if e.device_type() == torch.autograd.DeviceType.CUDA and kind == "kernel":
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.correlation_id()))
        elif kind in ("cuda_runtime", "cuda_driver"):
            launch_at[e.correlation_id()] = e.start_ns()
        elif kind == "user_annotation" and e.name() == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif kind == "user_annotation" and e.name().startswith(OP_PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU and kind in ("cpu_op",
                                                                           "user_annotation"):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} range")
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device if b > w0 and a < w1]
    intervals = [(a, b) for a, b, _, _ in device]
    busy_ns = union_length(intervals)

    # each op call's device intervals: the events whose launch lies in its range
    ranges.sort()
    starts = [r[0] for r in ranges]
    per_call: Dict[str, List[Tuple[int, int]]] = {}
    unlaunched = 0
    for a, b, _, corr in device:
        t = launch_at.get(corr)
        if t is None:
            unlaunched += 1
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
            per_call.setdefault(ranges[i][2], []).append((a, b))
    op_ns: Dict[str, Dict[int, float]] = {}
    for name, iv in per_call.items():
        op, num = name[len(OP_PREFIX):].rsplit("#", 1)
        op_ns.setdefault(op, {})[int(num)] = union_length(iv)

    # a name's time is the union of its intervals: a PDL launch waits on the
    # device for its predecessor, so a sum would count that wait
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for a, b, n, _ in device:
        spans.setdefault(n, []).append((a, b))
    by_name = {n: union_length(iv) for n, iv in spans.items()}
    # kernel names as the profiler gives them, cut to a readable length
    top = [(n[:160], s) for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    # the longest idle gaps, named by the innermost host range around each
    idle = sorted(gaps(intervals, w0, w1), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in idle:
        mid = (a + b) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        name = min(around, key=lambda h: h[1] - h[0])[2] if around else "host (no op)"
        named.append([name, (b - a) / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "op_s": {
        op: {k: v / 1e9 for k, v in calls.items()} for op, calls in op_ns.items()},
        "device_events": len(device), "unlaunched_events": unlaunched, "kinds": kinds,
        "breakdown": {"device_ops": [[n, s / 1e9] for n, s in top], "idle_gaps": named}}


TRACE_SECONDS = 10.0  # the traced part of a --trace 1 window


class Tracer:
    """The traced part of a window: ``torch.profiler`` and the ops' ranges
    from ``start`` until ``stop`` (the first ``TRACE_SECONDS`` of the
    window); ``readings`` then gives the profile's readings and the ops'
    counts, and takes the wrappers off."""

    def __init__(self, ops: List[OpCalls]):
        from torch.profiler import ProfilerActivity, profile

        self.ops = ops
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.range = torch.profiler.record_function(WINDOW)
        self.on = False

    def start(self) -> None:
        for op in self.ops:
            op.active = True
        self.prof.start()
        self.range.__enter__()
        self.on = True

    def stop(self) -> None:
        """Idempotent; the caller has synchronised the device."""
        if not self.on:
            return
        self.range.__exit__(None, None, None)
        self.prof.stop()
        self.on = False
        for op in self.ops:
            op.active = False

    def readings(self) -> Dict[str, Any]:
        self.stop()
        out = {"trace": read(self.prof), "op_counts": {op.attr: op.calls for op in self.ops}}
        for op in self.ops:
            op.restore()
        return out

