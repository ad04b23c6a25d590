"""PyTorch port: the recorder of utils/profiling.py (spans and counters a
request) at every layer of the request path, on the CPU, and the
benchmark's per-layer metrics that read it.

Every entry point called directly is one root span and one request; child
spans name their parent and lie inside it; a file read gives its
container, front-end and parallel spans in order; the pipeline's parse
spans sit on its worker threads; the counters count host syncs, launches
(none on the CPU: plain calls only), bytes copied from the host and the
bytes the CRC read, by either of its paths.  Off,
the recorder records nothing, opens no profiler range and costs under a
microsecond a span.  On, its spans match the profiler's ranges of the same
names, one offset apart."""

import json
import statistics
import threading
import timeit

import numpy as np
import pytest
import torch

import basisu_rs_tpu_torch as tb
import basisu_rs_tpu_torch.container.writer as tw
from basisu_rs_tpu_torch.base import to_device
from basisu_rs_tpu_torch.container import crc
from basisu_rs_tpu_torch.models import BasisCorpusPipeline, UastcTranscoder
from basisu_rs_tpu_torch.ops import etc1s, kernels
from basisu_rs_tpu_torch.parallel.mesh import (
    sharded_etc1s_transcode,
    sharded_mode_step,
    sharded_transcode,
    sharded_transcode_step,
    shard_blocks,
)
from basisu_rs_tpu_torch.utils import profiling
from basisu_rs_tpu_torch.utils.profiling import Records, SpanRecord, count, span, trace
from torch_cases import etc1s_codebooks

CPU = "cpu"
MESH = (CPU, CPU)  # two CPU "devices": the sharded paths split the rows


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    profiling.clear()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.clear()


def _uastc_file(golden):
    blocks = golden["bc7_in"]
    return tw.write_uastc_basis([
        dict(blocks=blocks[:32], nbx=8, nby=4, orig_width=32, orig_height=13),
        dict(blocks=blocks[32:47], nbx=3, nby=5, orig_width=11, orig_height=20),
        dict(blocks=blocks[47:48], nbx=1, nby=1, orig_width=3, orig_height=2),
    ])


def _etc1s(seed=0, e=40, s=30):
    rng = np.random.default_rng(seed)
    endpoints, selectors = etc1s_codebooks(rng, e, s)
    slices = [dict(ep_idx=rng.integers(0, e, nbx * nby), sel_idx=rng.integers(0, s, nbx * nby), nbx=nbx, nby=nby,
                   orig_width=w, orig_height=h) for nbx, nby, w, h in ((6, 4, 23, 14), (3, 5, 12, 20), (1, 1, 3, 2))]
    return endpoints, selectors, slices, tw.write_etc1s_basis(endpoints, selectors, slices)


def _by_start(rec):
    return sorted(rec.spans, key=lambda s: (s.start_ns, s.id))


# every entry point: (root span name, the call of golden and the files:
# _etc1s()'s four, then _uastc_file's)
ENTRIES = {
    "transcode_uastc_blocks": ("api.transcode", lambda g, f: tb.transcode_uastc_blocks(g["bc7_in"], "bc7", CPU)),
    "transcode_uastc_block_to_bc7": ("api.block", lambda g, f: tb.transcode_uastc_block_to_bc7(g["bc7_in"][0], CPU)),
    "run_etc1s_rgba": ("etc1s.run", lambda g, f: etc1s.run_etc1s_rgba(*f[:2], f[2][0]["ep_idx"], f[2][0]["sel_idx"],
                                                                       device=CPU)),
    "run_etc1s_etc1": ("etc1s.run", lambda g, f: etc1s.run_etc1s_etc1(*f[:2], f[2][0]["ep_idx"], f[2][0]["sel_idx"],
                                                                       device=CPU)),
    "read_to_bc7": ("container.read", lambda g, f: tb.read_to_bc7(f[4], device=CPU)),
    "read_to_rgba_uastc": ("container.read", lambda g, f: tb.read_to_rgba(f[4], device=CPU)),
    "read_to_rgba_etc1s": ("container.read", lambda g, f: tb.read_to_rgba(f[3], device=CPU)),
    "read_to_etc1_etc1s": ("container.read", lambda g, f: tb.read_to_etc1(f[3], device=CPU)),
    "read_to_astc": ("container.read", lambda g, f: tb.read_to_astc(f[4], mesh=MESH)),
    "read_to_etc2": ("container.read", lambda g, f: tb.read_to_etc2(f[4], device=CPU)),
    "read_to_uastc": ("container.read", lambda g, f: tb.read_to_uastc(f[4], device=CPU)),
    "sharded_transcode": ("parallel.transcode", lambda g, f: sharded_transcode(g["bc7_in"][:99], "bc7", MESH)),
    "sharded_transcode_step": ("parallel.transcode", lambda g, f: sharded_transcode_step("etc1", MESH)(
        shard_blocks(g["bc7_in"][:99], MESH))),
    "sharded_mode_step": ("parallel.mode", lambda g, f: sharded_mode_step(
        "bc7", 1, MESH)(g["bc7_in"][np.asarray(g["bc7_mode"]) == 1])),
    "sharded_etc1s_transcode": ("parallel.etc1s", lambda g, f: sharded_etc1s_transcode(
        "rgba", *f[:2], f[2][0]["ep_idx"], f[2][0]["sel_idx"], MESH)),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_entry_is_one_root_span_and_one_request(recorder, golden, entry):
    root_name, call = ENTRIES[entry]
    files = (*_etc1s(), _uastc_file(golden))
    recorder.clear()  # the files' writers ran on the host, outside the program
    call(golden, files)
    rec = recorder.records()
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == root_name
    assert {s.request for s in rec.spans} == {root.request}
    assert {request for request, _name in rec.counts} <= {root.request}
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    # a second call is a second request
    call(golden, files)
    assert len({s.request for s in recorder.records().spans}) == 2


def test_child_spans_name_their_parent_and_lie_inside_it(recorder, golden):
    tb.read_to_bc7(_uastc_file(golden), device=CPU)
    endpoints, selectors, slices, buf = _etc1s()
    tb.read_to_rgba(buf, device=CPU)
    etc1s.run_etc1s_rgba(endpoints, selectors, slices[0]["ep_idx"], slices[0]["sel_idx"], device=CPU)
    rec = recorder.records()
    by_id = {s.id: s for s in rec.spans}
    parents = {}
    for s in rec.spans:
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.request == s.request and p.thread == s.thread
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        parents.setdefault(s.name, set()).add(p.name)
    assert parents == {
        "container.validate": {"container.read"},
        "container.payload": {"container.read"},
        "container.error_check": {"container.read"},
        "container.images": {"container.read"},
        "parallel.transcode": {"container.read"},
        "dispatch.groups": {"parallel.transcode"},
        "dispatch.bincount": {"dispatch.groups"},
        "dispatch.counts": {"parallel.transcode"},
        "dispatch.launch": {"parallel.transcode"},
        "frontend.decode": {"container.read"},
        "frontend.slice": {"frontend.decode"},
        "parallel.etc1s": {"container.read"},
        "etc1s.pack": {"parallel.etc1s", "etc1s.run"},
        "etc1s.launch": {"parallel.etc1s", "etc1s.run"},
        "etc1s.index_check": {"etc1s.launch"},
    }


def test_file_reads_give_their_layers_spans_in_order(recorder, golden):
    tb.read_to_bc7(_uastc_file(golden), device=CPU)
    assert [s.name for s in _by_start(recorder.records())] == [
        "container.read", "container.validate", "container.payload", "parallel.transcode",
        "dispatch.groups", "dispatch.bincount", "dispatch.counts", "dispatch.launch", "container.error_check",
        "container.images",
    ]
    recorder.clear()
    tb.read_to_rgba(_etc1s()[3], device=CPU)
    assert [s.name for s in _by_start(recorder.records())] == [
        "container.read", "container.validate", "frontend.decode", "frontend.slice", "frontend.slice",
        "frontend.slice", "parallel.etc1s", "etc1s.pack", "etc1s.launch", "container.images",
    ]


def test_pipeline_worker_spans_sit_on_their_own_threads(recorder, golden, tmp_path):
    paths = []
    for k in range(3):
        path = tmp_path / f"f{k}.basis"
        path.write_bytes(_uastc_file(golden))
        paths.append(path)
    pipe = BasisCorpusPipeline("bc7", workers=2, device=CPU)
    assert len(list(pipe.run(paths))) == 3
    rec = recorder.records()
    main = threading.get_ident()
    parses = [s for s in rec.spans if s.name == "host/parse+crc"]
    reads = [s for s in rec.spans if s.name == "file/transcode"]
    assert len(parses) == len(reads) == 3
    assert all(s.parent is None and s.thread != main for s in parses)
    assert all(s.parent is None and s.thread == main for s in reads)
    assert len({s.request for s in parses + reads}) == 6
    # each read's program spans are children of its stage, on the main thread
    read_ids = {s.id for s in reads}
    assert sorted(s.parent in read_ids for s in rec.spans if s.name == "container.read") == [True] * 3
    assert {s.thread for s in rec.spans if s.name.startswith(("container.", "dispatch."))} == {main}


def test_stages_are_spans_of_their_names(recorder, golden):
    t = UastcTranscoder("bc7", device=CPU)
    t.transcode(golden["bc7_in"][:64])
    rec = recorder.records()
    roots = [s.name for s in _by_start(rec) if s.parent is None]
    assert roots == ["host/copy", "device/dispatch", "host/gather"]
    assert {s.name for s in rec.spans if s.parent is not None} == {"dispatch.groups", "dispatch.bincount",
                                                                     "dispatch.counts", "dispatch.launch"}
    assert t.profiler.stats["device/dispatch"].calls == 1


def test_counters_on_a_cpu_run(recorder, golden):
    kernels.reset_counts()
    buf = _uastc_file(golden)
    recorder.clear()  # the writer's CRC ran outside the program
    tb.read_to_bc7(buf, device=CPU)
    rec = recorder.records()
    # bincount's max, the partition's counts and the error check's nonzero; no launch on the CPU;
    # the CRC's bytes, the header's by the table and the data's by the fold where the CPU has it
    request, data = rec.spans[0].request, len(buf) - tb.Header.FILE_SIZE
    assert rec.counts == {(request, "host_syncs"): 3, (request, "crc_bytes"): 69 + data,
                          (request, "crc_fold_bytes"): data // 16 * 16 if crc.has_fold() else 0}
    assert rec.total("launches") == 0 and rec.total("h2d_bytes") == 0
    assert sum(map(sum, kernels.plain_call_counts().values())) > 0
    assert sum(map(sum, kernels.launch_counts().values())) == 0

    endpoints, selectors, slices, buf = _etc1s()
    for check_index, syncs in ((True, 1), (False, 0)):
        recorder.clear()
        etc1s.run_etc1s_rgba(endpoints, selectors, slices[0]["ep_idx"], slices[0]["sel_idx"], device=CPU,
                             check_index=check_index)
        assert recorder.records().total("host_syncs") == syncs
    recorder.clear()
    tb.read_to_rgba(buf, device=CPU)  # the front-end checked the indices: no sync
    assert {name for _request, name in recorder.records().counts} == {"crc_bytes", "crc_fold_bytes", "huff_symbols",
                                                                      "huff_root_symbols"}
    recorder.clear()
    kernels.mode_kernel("bc7", 1)(torch.from_numpy(golden["bc7_in"][:8]), torch.arange(4))
    assert recorder.records().counts == {(None, "host_syncs"): 2}  # the index check's min and max, outside a span


def test_host_to_device_copies_are_spanned_and_counted(recorder):
    host = torch.zeros(10, 4, dtype=torch.int32)
    with span("outer"):
        assert to_device(host, CPU) is host
        meta = to_device(host, "meta")  # a device that is not the host, without a card
        assert meta.device.type == "meta"
        assert to_device(meta, "meta") is meta
    rec = recorder.records()
    assert [s.name for s in _by_start(rec)] == ["outer", "parallel.h2d"]
    assert rec.total("h2d_bytes") == 160


def test_off_records_nothing_and_opens_no_range(golden, monkeypatch):
    profiling.disable()
    profiling.clear()

    def no_range(name):
        raise AssertionError(f"a profiler range was opened for {name!r}")

    monkeypatch.setattr(profiling, "_RANGE", no_range)
    tb.read_to_bc7(_uastc_file(golden), device=CPU)
    tb.transcode_uastc_blocks(golden["bc7_in"], "bc7", CPU)
    count("launches")
    assert span("a") is span("b")
    rec = profiling.records()
    assert rec.spans == [] and rec.counts == {}
    # on, every span opens one; a range that fails to open leaves no span open
    profiling.enable()
    try:
        with pytest.raises(AssertionError, match="'api.transcode'"):
            tb.transcode_uastc_blocks(golden["bc7_in"], "bc7", CPU)
        monkeypatch.undo()
        with span("after"):
            pass
        assert [(s.name, s.parent) for s in profiling.records().spans] == [("after", None)]
    finally:
        profiling.disable()
        profiling.clear()


def test_off_costs_under_a_microsecond_a_span():
    profiling.disable()
    env = {"span": span, "count": count}
    per_span = min(timeit.repeat("with span('x'): pass", globals=env, number=20000, repeat=7)) / 20000
    per_count = min(timeit.repeat("count('x')", globals=env, number=20000, repeat=7)) / 20000
    assert per_span < 1e-6 and per_count < 1e-6, (per_span, per_count)


def test_spans_match_the_profiler_ranges_one_offset_apart(recorder, golden):
    blocks = golden["bc7_in"][:64]
    tb.transcode_uastc_blocks(blocks, "bc7", CPU)  # the tables and the ranges' first use
    recorder.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            tb.transcode_uastc_blocks(blocks, "bc7", CPU)
            with span("test.outer"), span("test.inner"):
                torch.ones(256).sum()
    rec = recorder.records()
    names = {s.name for s in rec.spans}
    assert names == {"api.transcode", "dispatch.groups", "dispatch.bincount", "dispatch.counts", "dispatch.launch",
                     "test.outer", "test.inner"}
    diffs = []
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in rec.spans if s.name == name)
        ranges = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name)
        assert len(ranges) == len(mine) == 5, name
        for (a, b), (pa, pb) in zip(mine, ranges):
            diffs += [a / 1e3 - pa, b / 1e3 - pb]  # microseconds
    offset = statistics.median(diffs)
    assert max(abs(d - offset) for d in diffs) < 50, sorted(d - offset for d in diffs)


def test_trace_holds_the_program_spans(recorder, golden, tmp_path):
    with trace(str(tmp_path)):
        tb.transcode_uastc_blocks(golden["bc7_in"][:32], "bc7", CPU)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"api.transcode", "dispatch.groups", "dispatch.counts", "dispatch.launch"} <= names


def test_records_are_per_thread_and_thread_safe(recorder):
    barrier = threading.Barrier(4)

    def work():
        barrier.wait(timeout=30)
        for _ in range(200):
            with span("t.root"):
                count("n")
                with span("t.child"):
                    count("n", 2)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rec = recorder.records()
    assert len(rec.spans) == 1600 and rec.total("n") == 2400
    roots = {s.id: s for s in rec.spans if s.name == "t.root"}
    assert len({s.request for s in roots.values()}) == 800
    assert all(roots[s.parent].thread == s.thread and roots[s.parent].request == s.request
               for s in rec.spans if s.name == "t.child")
    assert set(rec.counts.values()) == {3}


# ---------------------------------------------------------------------------
# the benchmark's per-layer metrics that read the recorder
# ---------------------------------------------------------------------------

MS = 1_000_000  # ns


def _hand_records():
    """Two requests of each kind, spans of whole milliseconds."""
    spans, t = [], 0
    for name, ms in [("dispatch.groups", 1), ("dispatch.counts", 2), ("dispatch.launch", 3), ("etc1s.pack", 4),
                     ("etc1s.index_check", 5), ("container.validate", 6), ("frontend.decode", 7),
                     ("parallel.h2d", 8)] * 2:
        spans.append(SpanRecord(name, t, t + ms * MS, len(spans) + 1, None, len(spans) + 1, 1))
        t += ms * MS
    counts = {(1, "launches"): 19, (2, "launches"): 19, (1, "host_syncs"): 2, (2, "host_syncs"): 1,
              (1, "partition_device_ns"): 300_000, (2, "partition_device_ns"): 100_000, (1, "h2d_bytes"): 8_000_000,
              (1, "crc_bytes"): 1000, (2, "crc_bytes"): 600, (1, "crc_fold_bytes"): 928, (2, "crc_fold_bytes"): 512}
    return Records(spans, counts)


EXPECTED = {  # over 4 calls and 1000 blocks
    "dispatch.enqueue_ms": (2 * 1 + 2 * 3) / 4,
    "dispatch.sync_wait_ms": 2 * 2 / 4,
    "dispatch.partition_device_ms": 0.4 / 4,
    "dispatch.launches_per_call": 38 / 4,
    "etc1s.pack_ms": 2 * 4 / 4,
    "etc1s.index_check_ms": 2 * 5 / 4,
    "container.validate_ms": 2 * 6 / 4,
    "frontend.decode_ns_per_block": 2 * 7e6 / 1000,
    "parallel.h2d_gb_s": 8e6 / 16e-3 / 1e9,
    "host.syncs_per_read": 3 / 4,
    "container.crc_fold_pct": 100 * 1440 / 1600,
}


def _metric(name):
    from benchmark import core

    return core.load_metric(name)


@pytest.fixture
def metrics():
    """The metric modules, loaded (which turns the recorder on); the
    recorder off and empty afterwards."""
    try:
        yield {name: _metric(name) for name in EXPECTED}
    finally:
        profiling.disable()
        profiling.clear()


def test_metrics_are_in_the_benchmark_spec():
    from benchmark import core

    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in spec["per_layer"]}
    assert set(EXPECTED) <= set(listed)
    assert {listed[n]["source"] for n in EXPECTED} == {"host_clock", "device_trace"}
    assert listed["dispatch.partition_device_ms"]["source"] == "device_trace"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_a_hand_built_record(metrics, monkeypatch, name):
    from benchmark import core

    assert profiling._ON  # loading a metric turns the recorder on
    monkeypatch.setattr(profiling, "records", _hand_records)
    record = core.Record(config={}, traffic={}, calls=4, blocks=1000)
    assert metrics[name].read(record) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_nothing_without_records(metrics, monkeypatch, name):
    from benchmark import core

    record = core.Record(config={}, traffic={}, calls=4, blocks=1000)
    profiling.clear()
    assert metrics[name].read(record) is None  # the recorder recorded nothing
    # a program without the recorder: loading and reading raise nothing
    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(profiling, "enable")
    assert _metric(name).read(record) is None


def test_metrics_read_a_cpu_run(metrics, golden):
    from benchmark import core

    buf = _uastc_file(golden)
    profiling.clear()
    for _ in range(3):
        tb.read_to_bc7(buf, device=CPU)
    record = core.Record(config={}, traffic={}, calls=3, blocks=3 * 48)
    assert metrics["host.syncs_per_read"].read(record) == 3
    assert metrics["dispatch.launches_per_call"].read(record) == 0
    assert metrics["container.validate_ms"].read(record) > 0
    assert metrics["dispatch.enqueue_ms"].read(record) > 0
    data = len(buf) - tb.Header.FILE_SIZE
    assert metrics["container.crc_fold_pct"].read(record) == (
        pytest.approx(100 * (data // 16 * 16) / (69 + data)) if crc.has_fold() else 0)
    for name in ("parallel.h2d_gb_s", "dispatch.partition_device_ms", "etc1s.pack_ms", "frontend.decode_ns_per_block"):
        assert metrics[name].read(record) is None, name  # no copy to a card, no card, no ETC1S


def test_cuda_marks_are_read_once_and_reused(recorder, monkeypatch):
    """The event pair of the partition's device time, with a stand-in for
    CUDA's events: read into the counter, then recorded again."""

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.recorded = 0

        def record(self, stream=None):
            self.recorded += 1

        def elapsed_time(self, other):
            return 0.25  # ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(profiling, "_FREE_MARKS", {})
    card = torch.device("cuda", 0)
    assert profiling.cuda_mark(torch.device(CPU)) is None
    events = set()
    for _ in range(3):
        with span("request"):
            start, end = profiling.cuda_mark(card), profiling.cuda_mark(card)
            profiling.count_elapsed_ns("partition_device_ns", start, end)
        events |= {id(start[1]), id(end[1])}
    assert len(events) == 2  # two events, recorded three times each
    rec = recorder.records()
    assert rec.total("partition_device_ns") == 3 * 250_000 and len(rec.counts) == 3
    profiling.count_elapsed_ns("partition_device_ns", None, end)  # a pair not marked: nothing
    assert recorder.records().total("partition_device_ns") == 3 * 250_000
    profiling.disable()
    assert profiling.cuda_mark(card) is None


def test_device_counters_are_read_into_their_counter(recorder, monkeypatch):
    """A kernel's count on the card (a stand-in int64 [1] tensor): records()
    reads it into its counter outside any request and zeroes it, so a
    second read adds nothing; clear() zeroes it too.  Without a card, or
    with the recorder off, there is no counter to add to."""
    counter = torch.tensor([96], dtype=torch.int64)
    monkeypatch.setattr(profiling, "_DEVICE_COUNTERS", {("tile_warp_rounds", torch.device("cuda", 0)): counter})
    assert recorder.records().counts == {(None, "tile_warp_rounds"): 96} and int(counter) == 0
    counter += 32
    assert recorder.records().total("tile_warp_rounds") == 128
    counter += 5
    recorder.clear()
    assert int(counter) == 0 and recorder.records().counts == {}
    assert profiling.device_counter("tile_warp_rounds", torch.device(CPU)) is None
    profiling.disable()
    assert profiling.device_counter("tile_warp_rounds", torch.device("cuda", 0)) is None


@pytest.mark.parametrize("rounds, expected", [(40, 100 * 1000 / (32 * 40)), (0, None)])
def test_tile_lane_pct_reads_the_warp_rounds(monkeypatch, rounds, expected):
    """kernels.tile_lane_pct: the window's blocks over 32 lanes a warp-round
    of the counter `tile_warp_rounds`; nothing where no round was counted
    (the CPU, or a program without the tile kernel) or without records."""
    from benchmark import core

    try:
        metric = _metric("kernels.tile_lane_pct")
        assert profiling._ON
        counts = {(1, "launches"): 1, (None, "tile_warp_rounds"): rounds}
        spans = [SpanRecord("dispatch.launch", 0, MS, 1, None, 1, 1)]
        monkeypatch.setattr(profiling, "records", lambda: Records(spans, counts))
        record = core.Record(config={}, traffic={}, calls=4, blocks=1000)
        assert metric.read(record) == (pytest.approx(expected) if expected else None)
        assert metric.CPU_READS == "none"
        monkeypatch.delattr(profiling, "records")
        assert _metric("kernels.tile_lane_pct").read(record) is None
    finally:
        profiling.disable()
        profiling.clear()


def test_tile_lane_pct_is_in_the_benchmark_spec():
    from benchmark import core

    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    (m,) = [m for m in spec["per_layer"] if m["name"] == "kernels.tile_lane_pct"]
    assert (m["layer"], m["moves"], m["source"], m["workloads"]) == (
        "kernels", "resident_gtexels_s", "program_counter", ["uastc-bc7.resident-2e23"])
