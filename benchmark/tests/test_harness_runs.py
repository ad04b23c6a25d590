"""Whole runs of every cell on the CPU at small sizes, with the port's
plain versions: a sound run is correct; the control and each fault the
cells can have are not.  Then the import guard and the path without a
card, each in a fresh process, and one run on the card (marked)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import control, core

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "resident-2e23": {"blocks": 3000},
    "files-mip": {"textures": [[16, 2], [32, 1], [36, 1]]},
}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 1234567  # past 32 signed bits, as the driver's seeds are


def small_cell(name):
    cell = core.load_cell(name)
    cell.traffic.update(SMALL[cell.traffic["name"]], trace_seconds=0.2)
    return cell


def run(name, traced=False, seed=SEED):
    line, info = core.run_cell(small_cell(name), seed, 0.3, traced, "cpu", time.perf_counter())
    return line, info


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, traced):
    line, info = run(name, traced)
    assert line["correct"], info
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    cell = small_cell(name)
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # the CPU has no device trace: device-trace readers find nothing to read
    device_only = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert want - device_only <= set(line["metrics"]) <= want
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k not in device_only)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    checks = control.control_checks(small_cell(name), SEED, "cpu")
    assert checks["bad_bytes"][0] > checks["bad_bytes"][1]
    assert checks["bad_requests"][0] >= 1


def _half(out):
    """Half of the batch left out: the second half of the rows never written."""
    if isinstance(out, tuple):
        rows, err = out
        rows = rows.clone()
        rows[rows.shape[0] // 2 :] = 0
        return rows, err
    if isinstance(out, list):
        return out[: len(out) // 2]
    out = out.clone()
    out[out.shape[0] // 2 :] = 0
    return out


def _altered(out):
    """One answer altered where it is produced: one byte of one block."""
    if isinstance(out, tuple):
        return _altered(out[0]), out[1]
    if isinstance(out, list):
        first = out[-1]
        return out[:-1] + [type(first)(w=first.w, h=first.h, stride=first.stride, data=_altered(first.data))]
    out = out.clone()
    flat = out.view(torch.uint8).reshape(-1)
    flat[flat.numel() // 3] ^= 0x10
    return out


def _passthrough(out, driver):
    """The step returns its input unchanged: the UASTC blocks as the output."""
    return driver.blocks.clone(), out[1]


FAULTS = [("half_left_out", _half), ("answer_altered", _altered)]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f[0])
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(name, fault, monkeypatch):
    real = core.load_driver

    def load(cell, seed, device):
        d = real(cell, seed, device)
        call = d.call
        d.call = lambda i: fault[1](call(i))
        return d

    monkeypatch.setattr(core, "load_driver", load)
    line, info = run(name)
    assert not line["correct"]
    assert line["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


def test_passthrough_is_not_correct(monkeypatch):
    real = core.load_driver

    def load(cell, seed, device):
        d = real(cell, seed, device)
        call = d.call
        d.call = lambda i: _passthrough(call(i), d)
        return d

    monkeypatch.setattr(core, "load_driver", load)
    line, _ = run("uastc-bc7.resident-2e23")
    assert not line["correct"]


def test_a_refused_request_is_not_correct(monkeypatch):
    real = core.load_driver

    def load(cell, seed, device):
        d = real(cell, seed, device)

        def refuse(i):
            raise ValueError("refused")

        d.call = refuse
        return d

    monkeypatch.setattr(core, "load_driver", load)
    line, info = run("etc1s-rgba.files-mip")
    assert not line["correct"] and line["failed"] == 1 and info["errors"]


def _fresh(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_no_jax_in_a_run():
    code = (
        "import time, json\n"
        "from benchmark import core, control, run, trace\n"
        "for name, traffic in [('uastc-bc7.resident-2e23', {'blocks': 512}),"
        " ('etc1s-rgba.files-mip', {'textures': [[8, 1]]}), ('uastc-bc7.files-mip', {'textures': [[8, 1]]}),"
        " ('etc1s-rgba.resident-2e23', {'blocks': 512})]:\n"
        "    for traced in (False, True):\n"
        "        cell = core.load_cell(name); cell.traffic.update(traffic, trace_seconds=0.05)\n"
        "        line, _ = core.run_cell(cell, 1, 0.1, traced, 'cpu', time.perf_counter())\n"
        "        assert line['correct']\n"
        "print(json.dumps(core.forbidden_modules()))\n"
    )
    p = _fresh(code)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_reference_loads_nothing_of_the_program():
    p = _fresh(
        "import sys\n"
        "import benchmark.inputs, benchmark.reference.uastc, benchmark.reference.etc1s\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'basisu_rs_tpu_torch', 'basisu_rs_tpu', 'jax'}))\n"
    )
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("basisu_rs_tpu_torch.fake", "jaxlike", "flaxen"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.fake", type(sys)("jax.fake"))
    monkeypatch.setitem(sys.modules, "basisu_rs_tpu", type(sys)("basisu_rs_tpu"))
    assert core.forbidden_modules() == ["basisu_rs_tpu", "jax"]


def test_no_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name, "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
