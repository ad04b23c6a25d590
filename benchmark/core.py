"""The benchmark's core: a cell's files found by name, the measured
window, the sampled outputs, the spans, and the result line.

A cell is one entry of BENCHMARK.json's `workloads`.  Its configuration
is `configs/<config>.json`, its traffic mix `traffic/<traffic>.json`, the
mix's `driver` names `drivers/<driver>.py`, and each metric the cell
reports is read by `metrics/<metric>.py`.

A cell with a new traffic mix joins by new files and entries alone; no
file that is there needs an edit.  It brings:
- `traffic/<traffic>.json`: its `name`, its `driver`, the parameters the
  driver reads, and `cpu_test`, the values the benchmark's tests run the
  cell at on the CPU, each in place of a parameter of the file's own;
- where no driver reads the mix yet, `drivers/<driver>.py`, whose
  `Driver(config, traffic, seed, device)` exposes the methods below and
  may have `order`, the requests of one pass, whose sample keys the
  control walks (without it, request 0's key alone);
- a module for each metric that is new, as below;
- in BENCHMARK.json, the workload, and its name in the `workloads` of each
  end-to-end metric it reports and of at least one per-layer metric.
A driver exposes:
  setup()               make the inputs from the seed and warm up every shape
  call(i)               the i-th request through the program; returns its output
  work(i)               (texels, blocks) of the i-th request
  sample_key(i)         requests of one key give the same output; one is sampled a key
  release()             drop the program's inputs before the check
  check(samples)        the numbers compared, {name: (value, limit)}, of the
                        sampled (request, output) pairs
  control_outputs(keys) the control's output for each key, in the program's form
A metric's module has `read(record) -> float | None`, and may name
`SPANS`: {label: ["module:function", ...]}, program functions whose calls
the traced run times under that label, and `CPU_READS`: "none" where it
reads nothing without a card, "zero" where it may read 0 there (the
benchmark's tests on the CPU want every other host-clock metric above 0)."""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "basisu_rs_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = load_json(spec_path)
    (entry,) = [w for w in spec["workloads"] if w["name"] == name] or [None]
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path.name}")
    (config,) = [c for c in spec["configs"] if c["name"] == entry["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name,
        chips=entry["chips"],
        config=load_json(ROOT / config["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def load_driver(cell: Cell, seed: int, device):
    module = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    return module.Driver(cell.config, cell.traffic, seed, device)


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Spans:
    """Host-clock spans around program functions, by label, each also a
    profiler range of that name so that the trace can name idle gaps."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self._patched: list[tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, label: str):
        with torch.profiler.record_function(label):
            t = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(label, []).append(time.perf_counter() - t)

    def wrap(self, label: str, target: str) -> None:
        module_name, attr = target.split(":")
        module = importlib.import_module(module_name)
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(label):
                return fn(*args, **kwargs)

        self._patched.append((module, attr, fn))
        setattr(module, attr, timed)

    def restore(self) -> None:
        for module, attr, fn in reversed(self._patched):
            setattr(module, attr, fn)
        self._patched.clear()


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


class CudaLatency:
    """A request's latency on the card's clock: an event before the call
    and one after it, then a synchronize."""

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        self.start.record()

    def finish(self) -> float:
        self.end.record()
        torch.cuda.synchronize()
        return self.start.elapsed_time(self.end)


class HostLatency:
    """The same on the host clock, for runs of the harness on the CPU."""

    def begin(self) -> None:
        self.t = time.perf_counter()

    def finish(self) -> float:
        return (time.perf_counter() - self.t) * 1e3


class Reservoir:
    """Up to k outputs a key, drawn uniformly from the seed over every
    request of that key in the window."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, key, i: int, out) -> None:
        n = self.seen[key] = self.seen.get(key, 0) + 1
        kept = self.kept.setdefault(key, [])
        if len(kept) < self.k:
            kept.append((i, out))
        else:
            j = self.rng.randrange(n)
            if j < self.k:
                kept[j] = (i, out)

    def samples(self) -> list:
        return [s for key in sorted(self.kept) for s in self.kept[key]]


@dataclass
class Record:
    """What the window leaves for the metrics' readers."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    failed_calls: int = 0
    texels: int = 0
    blocks: int = 0
    latencies_ms: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    trace: object = None  # trace.Summary of the traced part of the window
    trace_blocks: int = 0
    device_kind: str = ""
    errors: list = field(default_factory=list)


def window(driver, record: Record, seconds: float, seed: int, latency, spans: Spans | None = None,
           trace_seconds: float = 0.0):
    """Closed loop, one caller: requests back to back for `seconds`, each
    timed from its call to the synchronize after it.  With spans, the
    requests of the first trace_seconds run under the profiler, which is
    reduced once the window has closed.  Returns the sampled outputs."""
    from . import trace

    reservoir = Reservoir(seed ^ 0x5EED, int(record.traffic.get("samples_per_key", 1)))
    scope = spans.span if spans else (lambda _label: contextlib.nullcontext())
    prof = trace.start() if spans and trace_seconds > 0 else None
    tracing = prof is not None
    outer = torch.profiler.record_function(trace.WINDOW) if tracing else contextlib.nullcontext()
    outer.__enter__()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    while i == 0 or time.perf_counter() < t_end:
        if tracing and time.perf_counter() - t0 >= trace_seconds:
            outer.__exit__(None, None, None)
            prof.stop()
            tracing = False
        latency.begin()
        try:
            with scope("bench.call"):
                out = driver.call(i)
        except Exception as exc:  # the program refused its own traffic: recorded, and not correct
            record.failed_calls += 1
            record.errors.append(f"request {i}: {type(exc).__name__}: {exc}")
            break
        with scope("bench.sync"):
            record.latencies_ms.append(latency.finish())
        texels, blocks = driver.work(i)
        record.texels += texels
        record.blocks += blocks
        if tracing:
            record.trace_blocks += blocks
        reservoir.offer(driver.sample_key(i), i, out)
        del out
        i += 1
    record.window_s = time.perf_counter() - t0
    record.calls = i
    if tracing:
        outer.__exit__(None, None, None)
        prof.stop()
    if prof is not None:
        record.trace = trace.summarize(prof, set(spans.seconds) | {"bench.call", "bench.sync"})
    return reservoir.samples()


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def check_line(checks: dict) -> dict:
    return {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> tuple[dict, dict]:
    """One run: set-up, the window, the check and the metrics.  Returns
    (result line, {checks, errors, timings})."""
    on_card = torch.device(device).type == "cuda"
    record = Record(config=cell.config, traffic=cell.traffic)
    timings = {"imports_s": time.perf_counter() - t_start}
    driver = load_driver(cell, seed, device)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
    record.setup_s = time.perf_counter() - t_start
    timings.update(getattr(driver, "timings", {}))

    metrics = [(m, load_metric(m["name"])) for m in (cell.per_layer if traced else cell.end_to_end)]
    spans = None
    if traced:
        spans = Spans()
        for _m, module in metrics:
            for label, targets in getattr(module, "SPANS", {}).items():
                for target in targets:
                    spans.wrap(label, target)
    latency = CudaLatency() if on_card else HostLatency()
    if on_card:  # the peak is the window's own: its request in flight and the sampled outputs it holds
        for d in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(d)
    t = time.perf_counter()
    try:
        samples = window(driver, record, seconds, seed, latency, spans,
                         float(cell.traffic.get("trace_seconds", seconds)) if traced else 0.0)
    finally:
        if spans:
            spans.restore()
            record.spans = spans.seconds
    device_line = {"platform": "gpu" if on_card else "cpu", "kind": "", "count": cell.chips, "memory_peak_bytes": 0}
    if on_card:
        device_line["kind"] = record.device_kind = torch.cuda.get_device_name(0)
        device_line["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in range(cell.chips)
        )
        device_line["power_limit_w"] = power_limit()
    if record.trace is not None:
        device_line["busy_s"] = record.trace.busy_s
        device_line["window_s"] = record.trace.window_s

    timings["window_and_trace_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver.release()
    try:
        checks = driver.check(samples)
    except Exception as exc:  # a check that cannot judge the outputs judges them wrong
        record.errors.append(f"check: {type(exc).__name__}: {exc}")
        checks = {"check_raised": (1, 0), "bad_requests": (len(samples), 0)}
    timings["check_s"] = time.perf_counter() - t
    checks["failed_calls"] = (record.failed_calls, 0)
    checks["unchecked"] = (0 if samples else 1, 0)
    correct = all(value <= limit for value, limit in checks.values())
    values = {}
    for m, module in metrics:
        v = module.read(record)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {
        "correct": correct,
        "attempted": record.calls + record.failed_calls,
        "failed": record.failed_calls + checks["bad_requests"][0],
        "metrics": values,
        "device": device_line,
    }
    if record.trace is not None:
        line["breakdown"] = record.trace.breakdown()
    line["checks"] = check_line(checks)
    return line, {"checks": checks, "errors": record.errors, "timings": timings}


def power_limit() -> str:
    """nvidia-smi's power limit of card 0 ("" where it cannot be read)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def stat_p95(values) -> float:
    """The 95th percentile of every value, linear between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
