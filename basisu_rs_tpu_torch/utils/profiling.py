"""Lightweight profiling: the program's spans and counters, per-stage wall
times and texel-rate counters, and device timers.

Port of `basisu_rs_tpu/utils/profiling.py`, plus the recorder.

The recorder: `span(name)` around the work of each layer, `count(name, n)`
at the sites that do countable work (kernel launches, host syncs, bytes
copied from the host); a kernel counts on the card into `device_counter`,
which `records()` reads into its counter.  It is off until `enable()`; off, `span` returns
one shared no-op context manager and `count` returns at once.  On, each
span records its name, start and end (`time.perf_counter_ns`), the span
that opened it and the request it belongs to: a span opened on a thread
with no open span is a root and starts a new request, so every entry point
of the port called directly is one request.  Each span is also a profiler
range (a RecordFunction, as `torch.profiler.record_function` opens), so
that a profiler trace (`trace`) holds the program's spans on the card's
clock, one constant offset from the recorder's.  Counters add up per request.  Records stay in memory
until `records()` reads them and `clear()` drops them.

A stage of `Profiler` is host wall time around work that may still be
running on the card when the stage closes: a stage that only enqueues
launches measures the enqueue, and the card's time lands in whichever
later stage waits for it (a copy to the host, a host read of a count).
Each stage is also a span of its name.  Device time comes from CUDA events
on a preloaded stream (`event_times_ms`, used by `chip_smoke.py` and
`tools/ablate_bc7.py`; `event_sequence_ms`, one event between the calls of
a sequence, used by `bench.py`), from a pair of events the recorder reads
after a sync the program makes anyway (`cuda_mark`, `count_elapsed_ns`),
or from `trace`, which records a `torch.profiler` trace of the host and
the card.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch

_LOCK = threading.Lock()  # stages may close, and counters add, on pipeline worker threads
PRELOAD_CYCLES = 20_000_000  # ~10 ms of sleep at 2 GHz: longer than any enqueue timed with it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet: the bytes bound of a launch


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_ON = False  # the one check of the off path
_SPANS: list = []  # SpanRecord, in the order the spans closed
_COUNTS: dict = {}  # (request, counter name) -> total
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_LOCAL = threading.local()  # .stack: the thread's open spans, innermost last
# A span's profiler range.  torch.profiler.record_function costs ~10 us an
# enter and exit on the host, profiler or not (two dispatched ops), which
# would land in the very spans it marks; the C++ range that torch's own
# compiled code uses costs ~0.5 us and keeps its times within a few us of
# the recorder's.  It is private to torch, hence the public fallback.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int | None  # the id of the span that opened it; None for a root
    request: int
    thread: int  # threading.get_ident() of the thread it ran on


@dataclass
class Records:
    """What the recorder holds: every closed span, and each counter's total
    by (request, name); request None counts work done outside any span."""

    spans: list
    counts: dict

    def seconds(self, *names: str) -> float:
        """Host seconds in the spans of these names, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name in names) * 1e-9

    def total(self, name: str) -> int:
        """A counter's total over every request."""
        return sum(n for (_request, counter), n in self.counts.items() if counter == name)


class _Off:
    """The span of the off path: one shared instance that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "range", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        # the range first: if it raises, the span never opened
        self.range = _RANGE(self.name)
        self.range.__enter__()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_REQUEST_IDS)
        self.id = next(_SPAN_IDS)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _LOCAL.stack.pop()
        _SPANS.append(SpanRecord(self.name, self.start_ns, end_ns, self.id, self.parent, self.request,
                                 threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records the work under it as span `name`
    (module docstring); with the recorder off, a shared one that does
    nothing."""
    if not _ON:
        return _OFF
    return _Span(name)


def enabled() -> bool:
    """Whether the recorder is on: for a site whose count costs work of its
    own, which it then does only when on."""
    return _ON


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the request open on this thread."""
    if not _ON:
        return
    stack = getattr(_LOCAL, "stack", None)
    key = (stack[-1].request if stack else None, name)
    with _LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + n


_FREE_MARKS: dict = {}  # torch.device -> timing events read and free to record again


def cuda_mark(device):
    """With the recorder on and `device` a card: a mark, a timing CUDA event
    recorded now on the device's current stream.  Otherwise None.  Events
    are reused once count_elapsed_ns has read them: one made anew every
    request cost the card's UASTC request ~0.06-0.2 ms on an H100."""
    if not _ON or device.type != "cuda":
        return None
    with _LOCK:
        free = _FREE_MARKS.get(device)
        event = free.pop() if free else None
    if event is None:
        event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return device, event


def count_elapsed_ns(name: str, start, end) -> None:
    """Add the card's nanoseconds from cuda_mark `start` to `end` to counter
    `name` (nothing if either is None).  Both events must have completed:
    call it after a host sync that waits for the end event, so that the
    read adds no sync of its own."""
    if start is None or end is None:
        return
    (device, first), (_device, last) = start, end
    count(name, round(first.elapsed_time(last) * 1e6))
    with _LOCK:
        _FREE_MARKS.setdefault(device, []).extend((first, last))


_DEVICE_COUNTERS: dict = {}  # (counter name, torch.device) -> int64 [1] tensor kernels add to


def device_counter(name: str, device):
    """With the recorder on and `device` a card: the int64 [1] tensor on the
    card that kernels add counter `name`'s counts to (made at first use),
    read into the counter, outside any request, by records().  Otherwise
    None, and the kernel counts nothing."""
    if not _ON or device.type != "cuda":
        return None
    with _LOCK:
        counter = _DEVICE_COUNTERS.get((name, device))
        if counter is None:
            counter = _DEVICE_COUNTERS[(name, device)] = torch.zeros(1, dtype=torch.int64, device=device)
    return counter


def _read_device_counters() -> None:
    """Add each device counter's count to its counter (request None) and
    zero it: one host read a counter, which waits for the kernels that add
    to it."""
    with _LOCK:
        counters = list(_DEVICE_COUNTERS.items())
    for (name, _device), counter in counters:
        n = int(counter.item())
        counter.zero_()
        if n:
            with _LOCK:
                _COUNTS[(None, name)] = _COUNTS.get((None, name), 0) + n


def enable() -> None:
    """Turn the recorder on."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn the recorder off; what it holds stays until clear()."""
    global _ON
    _ON = False


def records() -> Records:
    """A copy of every span closed and every counter added since clear(),
    the device counters read in first."""
    _read_device_counters()
    with _LOCK:
        return Records(list(_SPANS), dict(_COUNTS))


def clear() -> None:
    """Drop every record, and zero the device counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        for counter in _DEVICE_COUNTERS.values():
            counter.zero_()


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    texels: int = 0

    @property
    def mtexels_per_s(self) -> float:
        return self.texels / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class Profiler:
    """Accumulates per-stage timings; cheap enough to leave always-on."""

    stats: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str, texels: int = 0):
        """Time the work under it as stage `name`, which is also a span of
        that name (the JAX package's stage names).  Host wall time: a stage
        that only enqueues work on the card, as "device/dispatch" does,
        measures the enqueue, not the card's time."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with _LOCK:
                s = self.stats[name]
                s.calls += 1
                s.seconds += dt
                s.texels += texels

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            rate = f"  {s.mtexels_per_s:9.1f} Mtex/s" if s.texels else ""
            lines.append(f"{name:32s} {s.calls:6d} calls  {s.seconds*1e3:9.2f} ms{rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Optional torch.profiler trace of the host and the card (CPU and CUDA
    activities), written as a Chrome trace `trace.json` into log_dir; with
    no log_dir it does nothing.  With the recorder on (`enable()`), the
    program's spans are ranges of the trace, beside the card's kernels and
    on their clock."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def event_times_ms(fn, reps: int, launches: int = 1, preload: bool = False) -> list:
    """Time of one fn() call between two CUDA events, in ms, for each of
    `reps` runs; the events span `launches` calls and the time is divided
    by `launches`.

    Without preload the events also span the card's wait for the host to
    enqueue fn's launches, which is what a caller sees.  With preload=True a
    sleep kernel holds the stream while fn enqueues, so the events span only
    the card's own time for fn's kernels."""
    times = []
    for _ in range(reps):
        if preload:
            torch.cuda._sleep(PRELOAD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def event_sequence_ms(fns, reps: int, preload: bool = False) -> list:
    """Times of a sequence of calls, in ms: in each of `reps` runs, fns[0](rep),
    fns[1](rep), ... go in order with one CUDA event between each two, so
    each call's time is the gap between the events around it.  Returns one
    list of `reps` times a call.

    Unlike event_times_ms, which repeats one call, a call here is timed
    after the other calls of the sequence have run, so what they read and
    write has gone through the L2 cache in between.  preload=True holds the
    stream with a sleep kernel while the host enqueues a run, as in
    event_times_ms; only calls that do not wait on the host may be
    preloaded."""
    times = [[] for _ in fns]
    for rep in range(reps):
        if preload:
            torch.cuda._sleep(PRELOAD_CYCLES)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
        events[0].record()
        for fn, event in zip(fns, events[1:]):
            fn(rep)
            event.record()
        torch.cuda.synchronize()
        for k, t in enumerate(times):
            t.append(events[k].elapsed_time(events[k + 1]))
    return times
