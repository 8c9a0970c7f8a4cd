"""BENCHMARK.json against the contract's shape: names, units, keys, files, and
every per-layer metric's cells reporting the end-to-end metric it moves."""

import re
from pathlib import Path

import pytest

from benchmark.harness import manifest

REPO = Path(__file__).resolve().parents[2]
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s of compile
    # a cell, 1200 s spare, within 43200 s with 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert (REPO / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_is_there():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in manifest.metrics_of(BENCH, cell, "end_to_end")]
    per = manifest.metrics_of(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader_and_cells(metric):
    assert callable(manifest.reader(metric))
    m = next(x for x in METRICS if x["name"] == metric)
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    w = manifest.cell(BENCH, cell)
    assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    assert manifest.limits(cell)
    assert manifest.config(BENCH, w["config"])["name"] == w["config"]


def test_rooflines_and_mfu_are_named_for_the_contract():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
