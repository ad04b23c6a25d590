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
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 1234567  # past 32 signed bits, as the driver's seeds are


def small_cell(name):
    """The cell at the size its traffic file gives runs on the CPU (`cpu_test`)."""
    cell = core.load_cell(name)
    cell.traffic.update(cell.traffic["cpu_test"], trace_seconds=0.2)
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
    want = cell.per_layer if traced else cell.end_to_end
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) <= {m["name"] for m in want}
    for m in want:
        if traced and m["source"] == "device_trace":  # the CPU has no device trace: its per-layer readers find nothing
            continue
        # a metric's module says where it reads nothing, or may read 0, without a card
        reads = getattr(core.load_metric(m["name"]), "CPU_READS", None)
        if reads == "none" and m["name"] not in got:
            continue
        assert m["name"] in got, m["name"]
        assert got[m["name"]] >= 0 if reads == "zero" else got[m["name"]] > 0, (m["name"], got[m["name"]])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    checks = control.control_checks(small_cell(name), SEED, "cpu")
    assert checks["bad_bytes"][0] > checks["bad_bytes"][1]
    assert checks["bad_requests"][0] >= 1


def _half(out):
    """Half of the batch left out: the second half of the rows never
    written, or of the images never made, in every list of an output's
    nesting of lists and tuples ((rows, err) keeps its err)."""
    if isinstance(out, torch.Tensor):
        out = out.clone()
        out[out.shape[0] // 2 :] = 0
        return out
    if isinstance(out, tuple):
        return (_half(out[0]), *out[1:])
    if out and isinstance(out[0], (list, tuple)):
        return [_half(o) for o in out]
    return out[: len(out) // 2]


def _altered(out):
    """One answer altered where it is produced: one byte of one block, in
    the last image or rows of an output's nesting of lists and tuples."""
    if isinstance(out, torch.Tensor):
        out = out.clone()
        flat = out.view(torch.uint8).reshape(-1)
        flat[flat.numel() // 3] ^= 0x10
        return out
    if isinstance(out, tuple):
        return (_altered(out[0]), *out[1:])
    if isinstance(out, list):
        return out[:-1] + [_altered(out[-1])]
    return type(out)(w=out.w, h=out.h, stride=out.stride, data=_altered(out.data))  # an image


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
    # the check caught the fault in the outputs: no call raised on it
    checks = line["checks"]
    assert checks["failed_calls"]["value"] == 0, info["errors"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in ("bad_bytes", "bad_images") if k in checks), checks


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
        f"for name in {CELLS!r}:\n"
        "    for traced in (False, True):\n"
        "        cell = core.load_cell(name); cell.traffic.update(cell.traffic['cpu_test'], trace_seconds=0.05)\n"
        "        line, _ = core.run_cell(cell, 1, 0.1, traced, 'cpu', time.perf_counter())\n"
        "        assert line['correct'], name\n"
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
