"""BENCHMARK.json against the benchmark's files and naming rules, and a
new cell joining by new files alone."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from xml.etree import ElementTree

import pytest

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
TRAFFIC = sorted({w["traffic"] for w in SPEC["workloads"]})


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


def _numbers(value):
    """Every number in a parameter's nesting of lists."""
    if isinstance(value, list):
        return [n for v in value for n in _numbers(v)]
    assert isinstance(value, (int, float)) and not isinstance(value, bool), value
    return [value]


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_has_a_cpu_size(name):
    """`cpu_test` only shrinks the mix's own sizes for runs on the CPU: it
    names only numeric parameters of the file's own, none that the harness
    reads for every mix (samples, the traced seconds), and no number in it,
    nor their sum, is above the full-size value's."""
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
    small = traffic["cpu_test"]
    assert small and set(small) <= set(traffic) - {"name", "driver", "why", "cpu_test", "samples_per_key", "trace_seconds"}
    for key, value in small.items():
        cut, full = _numbers(value), _numbers(traffic[key])
        assert cut and max(cut) <= max(full) and sum(cut) <= sum(full), (key, value, traffic[key])


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


def test_a_new_mix_joins_by_new_files(tmp_path):
    """In a copy of the benchmark, a cell with a mix of its own, added as a
    traffic file and entries of BENCHMARK.json alone, passes the harness's
    own tests: the probe mix `probe-mip` (the files driver at files-mip's
    sizes) as the cell `uastc-bc7.probe-mip`, under the file cells'
    metrics.  The copy's tests run in a fresh process, with the repository
    on the path for the program."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    files_mip = json.loads((ROOT / "benchmark" / "traffic" / "files-mip.json").read_text())
    probe = dict(files_mip, name="probe-mip", cpu_test={"textures": [[16, 1], [32, 1]]},
                 why="files-mip's reads under a name of their own")
    (tmp_path / "benchmark" / "traffic" / "probe-mip.json").write_text(json.dumps(probe, indent=2))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "uastc-bc7.probe-mip"
    spec["workloads"].append({"name": cell, "config": "uastc-bc7", "traffic": "probe-mip", "chips": 1,
                              "why": "the UASTC file reads of uastc-bc7.files-mip, by a new mix's files"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if metric["name"] in ("file_mtexels_s", "file_p95_ms", "device.idle_pct.file"):
            metric["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    xml = tmp_path / "probe.xml"
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONDONTWRITEBYTECODE="1")
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-k", "probe-mip", "-p", "no:cacheprovider",
         f"--junitxml={xml}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stdout[-4000:]  # none failed
    suite = ElementTree.parse(xml).getroot().find("testsuite")
    assert int(suite.get("tests")) - int(suite.get("skipped")) >= 5, p.stdout[-4000:]
