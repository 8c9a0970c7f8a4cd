"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), its limits (``limits/<cell>.json``) and each
metric's reader (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def load(path: Path = REPO / "BENCHMARK.json") -> Dict[str, Any]:
    return json.loads(path.read_text())


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((REPO / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def limits(name: str) -> Dict[str, float]:
    return json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())["limits"]


def metrics_of(manifest: Dict[str, Any], cell_name: str, group: str) -> List[Dict[str, Any]]:
    """The metrics of ``group`` (end_to_end or per_layer) this cell reports."""
    return [m for m in manifest[group] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable[[Dict[str, Any]], Any]:
    """``metrics/<base>.py``, ``<base>`` the name before its first dot: one
    reader serves each of its forms (``idle_pct.py`` reads ``idle_pct.b1``)."""
    path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
