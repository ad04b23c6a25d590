"""BENCHMARK.json against the benchmark's files and naming rules."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell, 1200 spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    assert callable(core.load_metric(metric["name"]).read)
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        # every cell the metric lists reports the end-to-end metric it moves
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    c = core.load_cell(cell["name"])
    assert cell["chips"] in (1, 4)
    assert (ROOT / "benchmark" / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.config["name"] == cell["config"] and c.traffic["name"] == cell["traffic"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "benchmark"
    data = json.loads(path.read_text())
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    assert data["guarantees"] and data["control"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    assert 4 * sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(4, len(SPEC["workloads"]))
    assert math.isfinite(data["hbm_bytes_per_block"])
