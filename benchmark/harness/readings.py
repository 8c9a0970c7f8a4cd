"""What the metric readers compute from a run's readings (``run``):

* ``setup_s``: seconds from the process's start to the window's;
* ``window``: the host's readings of the window (``harness/serving.py``);
* ``trace``: the profile's readings (``harness/trace.py``), traced runs only;
* ``op_counts``: (operations, bytes) of each traced op call by number.

A reader that finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import peaks, stats


def audio_s_per_s(run: Dict[str, Any]) -> Optional[float]:
    w = run["window"]
    return w["audio_s"] / w["window_s"] if w.get("audio_s") else None


def request_ms(run: Dict[str, Any], q: float) -> Optional[float]:
    lat = run["window"].get("latencies_s")
    return stats.percentile(lat, q) * 1e3 if lat else None


def mfu_pct(run: Dict[str, Any]) -> Optional[float]:
    """The model's operations over the TF32 peak, over the part of the window
    after the profiler stopped (all of it in an untraced run), so that the
    profiler's host cost does not lower it."""
    w = run["window"]
    if not w.get("untraced_flops"):
        return None
    return 100.0 * w["untraced_flops"] / w["untraced_s"] / peaks.TF32_FLOPS


def pad_frames_pct(run: Dict[str, Any]) -> Optional[float]:
    w = run["window"]
    if not w.get("padded_frames"):
        return None
    return 100.0 * (w["padded_frames"] - w["useful_frames"]) / w["padded_frames"]


def idle_pct(run: Dict[str, Any]) -> Optional[float]:
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(run: Dict[str, Any], *ops: str) -> Optional[float]:
    """Sum over the ops' traced calls of each call's least time,
    max(operations / TF32 peak, bytes / HBM bandwidth), over the sum of
    their measured times."""
    least = spent = 0.0
    for op in ops:
        counts = run.get("op_counts", {}).get(op)
        times = (run.get("trace") or {}).get("op_s", {}).get(op)
        if not times or not counts:
            return None
        least += sum(max(counts[i][0] / peaks.TF32_FLOPS, counts[i][1] / peaks.HBM_BYTES_PER_S)
                     for i in times)
        spent += sum(times.values())
    return 100.0 * least / spent if spent > 0 else None


def step_ms(run: Dict[str, Any]) -> Optional[float]:
    w = run["window"]
    return 1e3 * w["window_s"] / w["steps"] if w.get("steps") else None
