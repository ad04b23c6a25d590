"""The reader of the traced run: torch.profiler over the first part of the
window, reduced to the device's busy time, its operations by name, and
its idle gaps named by the host span that covers each."""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

import torch

WINDOW = "bench.window"
OUTSIDE = "harness"  # a gap no span covers: the benchmark's own loop


def start():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    )
    prof.start()
    return prof


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)", "anon")
    name = name.split("(")[0].strip()
    return (name[5:] if name.startswith("void ") else name)[:160]


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label_of(t: float, spans: dict) -> str:
    """The innermost span covering time t (each label's spans are disjoint
    and sorted)."""
    best, best_len = OUTSIDE, float("inf")
    for label, (starts, ends) in spans.items():
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and ends[k] >= t and ends[k] - starts[k] < best_len:
            best, best_len = label, ends[k] - starts[k]
    return best


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: dict  # short name -> seconds on the device
    idle: dict  # span label -> idle seconds under it
    intervals: dict  # short name -> its (start, end) microseconds
    lo: float
    hi: float

    def kernel_s(self, pattern: str) -> float:
        """Seconds in which a device operation whose name matches ran: the
        union of their intervals, since a chained launch starts before the
        one ahead of it ends."""
        rx = re.compile(pattern)
        spans = [iv for name, ivs in self.intervals.items() if rx.search(name) for iv in ivs]
        return sum(b - a for a, b in union(spans, self.lo, self.hi)) * 1e-6

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle)}


def summarize(prof, labels: set) -> Summary:
    """Reduce a stopped profiler's events over the WINDOW range (times in
    microseconds on the profiler's clock)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    wanted = set(labels) | {WINDOW}
    win = [e.time_range for e in events if e.name == WINDOW and e.device_type != cuda]
    # the device's own operations; a host range also shows on the device's
    # timeline as a user annotation, which is not work
    device = [e for e in events if e.device_type == cuda and e.name not in wanted
              and not getattr(e, "is_user_annotation", False)]
    if win:
        lo, hi = win[0].start, win[0].end
    else:
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
    ops: dict = {}
    intervals: dict = {}
    for e in device:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            name = short_name(e.name)
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
            intervals.setdefault(name, []).append((a, b))
    busy = union([(e.time_range.start, e.time_range.end) for e in device], lo, hi)
    spans: dict = {}
    for e in events:
        if e.name in labels and e.device_type != cuda:
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    spans = {k: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)]) for k, v in spans.items()}
    idle: dict = {}
    for a, b in gaps(busy, lo, hi):
        label = label_of((a + b) / 2, spans)
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return Summary(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=ops,
        idle=idle,
        intervals=intervals,
        lo=lo,
        hi=hi,
    )
