"""Lightweight profiling: per-stage wall times and texel-rate counters.

Port of `basisu_rs_tpu/utils/profiling.py`.  A stage is host wall time
around work that may still be running on the card when the stage closes:
a stage that only enqueues launches measures the enqueue, and the card's
time lands in whichever later stage waits for it (a copy to the host, a
host read of a count).  Device time comes from CUDA events on a preloaded
stream (`event_times_ms`, used by `chip_smoke.py` and `tools/ablate_bc7.py`;
`event_sequence_ms`, one event between the calls of a sequence, used by
`bench.py`) or from `trace`, which records a `torch.profiler` trace of the
host and the card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

_LOCK = threading.Lock()  # stages may close on pipeline worker threads
PRELOAD_CYCLES = 20_000_000  # ~10 ms of sleep at 2 GHz: longer than any enqueue timed with it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet: the bytes bound of a launch


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
        t0 = time.perf_counter()
        try:
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
    no log_dir it does nothing."""
    if not log_dir:
        yield
        return
    import torch

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
    import torch

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
    import torch

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
