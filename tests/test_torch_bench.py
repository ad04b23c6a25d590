"""The port's throughput benchmark (`basisu_rs_tpu_torch.bench`) and its
host front-end tool (`basisu_rs_tpu_torch.tools.bench_etc1s_host`) on the
CPU, against the JAX system's `bench.py` and `tools/bench_etc1s_host.py`.

The bench measures only on a card; here its functions run the kernels'
plain versions at a tiny size with an injected timer, which shows that
their output checks pass on right outputs and raise on a corrupted one.
No timing is asserted: a rate taken here is a CPU number.
"""

import contextlib
import importlib.util
import io
import json
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # the JAX system's bench.py
import basisu_rs_tpu.container.writer as jax_writer
import basisu_rs_tpu.models.transcoder as jax_transcoder
from basisu_rs_tpu_torch import bench
from basisu_rs_tpu_torch.base import shard_bounds
from basisu_rs_tpu_torch.ops import etc1s, kernels
from basisu_rs_tpu_torch.tools import bench_etc1s_host as host_tool

_spec = importlib.util.spec_from_file_location("jax_bench_etc1s_host", ROOT / "tools" / "bench_etc1s_host.py")
jax_host_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_host_tool)

N_TINY = 700  # golden blocks tiled once and cut: every mode, a ragged last tile
MESH = ("cpu",) * 3
SIZES = dict(ETC1S_N=500, HOST_BLOCKS=1 << 12, CORPUS=(2, 8, 8), PIPELINE_CORPUS=(2, 8, 8))


def cpu_timer(fns, reps):
    """event_sequence_ms's call order (rep after rep, the sequence in order)
    without CUDA events: every call 1 ms."""
    times = [[] for _ in fns]
    for r in range(reps):
        for k, fn in enumerate(fns):
            fn(r)
            times[k].append(1.0)
    return times


# ---------------------------------------------------------------------------
# inputs and the host front-end tool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 607, 608, 1000, 2 * 608 + 5])
def test_build_batch_equals_bench_py(n):
    got = bench.build_batch(n)
    assert got.dtype == np.uint8 and got.shape == (n, 16)
    np.testing.assert_array_equal(got, jax_bench.build_batch(n))


@pytest.mark.parametrize("target", ["bc7", "astc", "rgba", "etc1", "etc2"])
def test_golden_outputs_tile_as_the_inputs(golden, target):
    out = golden[f"{target}_out"].view(np.uint8).reshape(len(golden["bc7_in"]), -1)
    got = bench.golden_outputs(target, 2 * len(out) + 3)
    np.testing.assert_array_equal(got, np.concatenate([out, out, out[:3]]))


def test_make_slice_equals_the_jax_tool(monkeypatch):
    files = []
    write = jax_writer.write_etc1s_basis_fuzz

    def capture(*args, **kw):
        res = write(*args, **kw)
        files.append(res[0])
        return res

    monkeypatch.setattr(jax_writer, "write_etc1s_basis_fuzz", capture)
    nbx, nby = 96, 40
    _, j_data, j_ep, j_sel = jax_host_tool.make_slice(nbx, nby)
    buf, ep, sel = host_tool.slice_file(nbx, nby)
    assert bytes(buf) == bytes(files[0])
    models, data, exp_ep, exp_sel = host_tool.make_slice(nbx, nby)
    assert bytes(data) == bytes(j_data)
    for a, b in ((ep, j_ep), (exp_ep, j_ep), (sel, j_sel), (exp_sel, j_sel)):
        np.testing.assert_array_equal(a, b)
    got_ep, got_sel = host_tool.decode_slice(models, nbx, nby, data)
    np.testing.assert_array_equal(got_ep, j_ep)
    np.testing.assert_array_equal(got_sel, j_sel)


def test_threads_share_one_decoder_handle():
    nbx, nby = 160, 160
    models, data, exp_ep, exp_sel = host_tool.make_slice(nbx, nby)
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda _: host_tool.decode_slice(models, nbx, nby, data), range(16)))
    assert len(results) == 16
    for ep, sel in results:
        np.testing.assert_array_equal(ep, exp_ep)
        np.testing.assert_array_equal(sel, exp_sel)


def test_decode_slice_releases_the_gil():
    """tests/test_thread_scaling.py's method: with a switch interval far
    beyond the test's length, a pure-Python spinner thread runs during the
    decodes only if the native call drops the GIL."""
    nbx, nby = 160, 160
    models, data, _, _ = host_tool.make_slice(nbx, nby)
    for _ in range(4):
        host_tool.decode_slice(models, nbx, nby, data)  # warm
    stop = False
    count = 0

    def spin():
        nonlocal count
        while not stop:
            count += 1
            if not (count & 0xFFFF):
                time.sleep(0)  # lets the main thread take the GIL back

    old = sys.getswitchinterval()
    sys.setswitchinterval(300.0)
    spinner = threading.Thread(target=spin)
    try:
        spinner.start()
        time.sleep(0.05)  # sleep drops the GIL: the spinner enters its loop
        start = count
        for _ in range(10):
            host_tool.decode_slice(models, nbx, nby, data)
        grown = count - start
    finally:
        stop = True
        sys.setswitchinterval(old)
        spinner.join(timeout=60)
    assert not spinner.is_alive()
    assert grown > 1000, f"spinner starved during the native decode (grew {grown})"


def test_host_tool_main_runs(capsys):
    assert host_tool.main(["--blocks", "4096", "--reps", "1", "--workers", "2"]) == 0
    out = capsys.readouterr().out
    assert "Mblk/s/core" in out and "2 worker(s)" in out


# ---------------------------------------------------------------------------
# the line
# ---------------------------------------------------------------------------


def test_main_without_a_card_prints_the_null_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.METRIC and line["unit"] == "Mtexels/s" and line["value"] is None
    assert "CUDA" in line["error"]


def jax_line(cpu_count: int) -> dict:
    """bench.py's main() with its measurements stubbed (their keys come from
    its own code: per-mode timings return 1 ms, the ETC1S draws shrink, the
    corpus run is real at 4x4 blocks with its transcoders stubbed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bench, "N_BLOCKS", 64)
        mp.setattr(jax_bench, "mode_rate", lambda target, m, lanes: (1e-3, lanes.shape[0]))
        mp.setattr(jax_bench, "mode_rate_sharded", lambda target, m, lanes, mesh: (1e-3, lanes.shape[0]))
        mp.setattr(jax_bench, "_measure_chained", lambda *a, **k: 1e-3)
        mp.setattr(jax_bench, "bench_etc1s", partial(jax_bench.bench_etc1s, n=1024))
        mp.setattr(jax_bench, "bench_etc1s_sharded", partial(jax_bench.bench_etc1s_sharded, n=8192))
        mp.setattr(jax_bench, "bench_etc1s_host", lambda: 1e8)
        mp.setitem(sys.modules, "bench_etc1s_host", types.SimpleNamespace(aggregate_rate=lambda w: 1e8))
        mp.setattr(jax_bench, "bench_corpus_device", partial(jax_bench.bench_corpus_device, 1, 4, 4))
        mp.setattr(jax_transcoder, "UastcTranscoder",
                   lambda target: types.SimpleNamespace(transcode_async=lambda b: types.SimpleNamespace(groups=[])))
        mp.setattr(jax_transcoder, "Etc1sMultiCorpusTranscoder",
                   lambda target: types.SimpleNamespace(transcode_files=lambda w, device: [[] for _ in w]))
        mp.setattr(jax_bench.os, "cpu_count", lambda: cpu_count)
        mp.delenv("BENCH_FAST", raising=False)
        mp.delenv("BENCH_ALL", raising=False)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_bench.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_line():
    """The port's line from measure() on the CPU at a tiny size (plain
    versions, injected timer, three CPU "devices" as the mesh)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SIZES.items():
            mp.setattr(bench, k, v)
        mp.setattr(bench.os, "cpu_count", lambda: 4)
        rate, extra = bench.measure("cpu", N_TINY, bench_all=True, reps=2, timer=cpu_timer, mesh=MESH)
    return bench.result_line(rate, extra, {"name": "card", "count": 1, "power_limit_w": "700.00 W"})


def test_line_keys_equal_bench_py(port_line):
    line = jax_line(4)
    assert set(line) - {"vs_baseline"} == set(bench.LINE_KEYS)
    assert set(port_line) == set(bench.LINE_KEYS) | {"device"}
    assert port_line["metric"] == line["metric"] and port_line["unit"] == line["unit"]
    assert all(np.isfinite(v) and v > 0 for k, v in port_line.items() if k not in ("metric", "unit", "device"))


def test_one_core_adds_the_degenerate_flag_as_bench_py():
    assert set(jax_line(1)) - set(jax_line(4)) == {"etc1s_host_degenerate"}
    one, four = bench.host_frontend(1, 1 << 12), bench.host_frontend(4, 1 << 12)
    assert set(one) - set(four) == {"etc1s_host_degenerate"} and set(four) <= set(bench.LINE_KEYS)
    assert one["etc1s_host_mblocks_s_total"] == one["etc1s_host_mblocks_s_core"]


def test_fast_line_is_the_headline_only(monkeypatch):
    rate, extra = bench.measure("cpu", N_TINY, fast=True, reps=1, timer=cpu_timer, mesh=MESH)
    assert rate > 0 and extra == {}


# ---------------------------------------------------------------------------
# each measurement's output check
# ---------------------------------------------------------------------------


def _run(case: str):
    blocks = bench.build_batch(N_TINY)
    if case in bench.OTHER_TARGETS + ("bc7",):
        return bench.bench_target(case, blocks, "cpu", reps=2, timer=cpu_timer)
    if case == "etc1s":
        return bench.bench_etc1s("cpu", 500, reps=2, timer=cpu_timer)
    if case == "sharded":
        return bench.bench_target_sharded("bc7", blocks, MESH, reps=2, timer=cpu_timer)
    if case == "etc1s_sharded":
        return bench.bench_etc1s_sharded(MESH, 500, reps=2, timer=cpu_timer)
    assert case == "corpus"
    return bench.bench_corpus_device("cpu", {}, 1, 4, 4)


CASES = ["bc7", "astc", "rgba", "etc1", "etc2", "etc1s", "sharded", "etc1s_sharded", "corpus"]


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_pass_the_output_check(case):
    res = _run(case)
    values = res.values() if isinstance(res, dict) else [res]
    assert all(np.isfinite(v) and v > 0 for v in values)
    if case == "etc1s":
        assert set(res) == {"rgba", "rgba_alpha", "etc1"}


# each function's check once (the targets share bench_target's); err flags
# where the kernels have them (K1-K5)
CORRUPT = [(case, "out") for case in ("bc7", "etc1s", "sharded", "etc1s_sharded", "corpus")] + [
    (case, "err") for case in ("bc7", "sharded", "corpus")]


@pytest.mark.parametrize("case,what", CORRUPT)
def test_a_corrupted_output_raises(monkeypatch, case, what):
    """One wrong byte (or one err flag) in every call's output must fail the
    check before a rate is returned."""
    mode_call, etc1s_call = kernels.ModeKernel.__call__, etc1s.Etc1sKernel.__call__

    def corrupt_mode(self, blocks, index=None, out=None, err=None, **kw):
        out, err = mode_call(self, blocks, index, out, err, **kw)
        if what == "out":
            out[-1, -1] ^= 1
        else:
            err[-1] = True
        return out, err

    def corrupt_etc1s(self, *args, **kw):
        out = etc1s_call(self, *args, **kw)
        out[-1, -1] ^= 1
        return out

    monkeypatch.setattr(kernels.ModeKernel, "__call__", corrupt_mode)
    monkeypatch.setattr(etc1s.Etc1sKernel, "__call__", corrupt_etc1s)
    with pytest.raises(RuntimeError, match="differs|checksum"):
        _run(case)


def test_a_missing_launch_raises(monkeypatch):
    """The counters must show one call a mode and a rep."""
    monkeypatch.setattr(kernels, "plain_call_counts", lambda: {t: [0] * kernels.N_MODES for t in kernels.TARGETS})
    with pytest.raises(RuntimeError, match="calls of"):
        bench.bench_target("bc7", bench.build_batch(N_TINY), "cpu", reps=2, timer=cpu_timer)


@pytest.mark.parametrize("n,shards", [(1, 3), (4, 3), (5, 3), (700, 3), (608, 8), (0, 2)])
def test_sharded_launches_count_the_non_empty_shards(n, shards):
    assert bench.sharded_launches(n, shards) == sum(b > a for a, b in shard_bounds(n, shards))
