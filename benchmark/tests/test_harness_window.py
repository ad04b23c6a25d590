"""The window's arithmetic: rates and the p95 over every request, a stall
moving both; the reservoir of sampled outputs; the trace's interval sums."""

import time

import numpy as np
import pytest

from benchmark import core, trace


class SleepDriver:
    """Requests that take `ms[i % len(ms)]` milliseconds and do 16 texels a block."""

    def __init__(self, ms, blocks=1000):
        self.ms, self.n = ms, blocks

    def call(self, i):
        time.sleep(self.ms[i % len(self.ms)] / 1e3)
        return i

    def work(self, i):
        return 16 * self.n, self.n

    def sample_key(self, i):
        return i % 3


def run(ms, seconds=0.4):
    record = core.Record(config={}, traffic={"samples_per_key": 1})
    samples = core.window(SleepDriver(ms), record, seconds, 5, core.HostLatency())
    return record, samples


def metric(name, record):
    return core.load_metric(name).read(record)


def test_rate_counts_every_request_over_the_window():
    record, samples = run([2.0])
    assert record.calls == len(record.latencies_ms) and record.window_s >= 0.4
    assert record.texels == 16 * 1000 * record.calls
    rate = metric("resident_gtexels_s", record)
    assert rate == pytest.approx(record.texels / record.window_s / 1e9)
    assert metric("file_mtexels_s", record) == pytest.approx(rate * 1e3)
    assert sorted(k for k in range(3)) == sorted({i % 3 for i, _ in samples})


def test_a_stall_moves_rate_and_tail():
    steady, _ = run([2.0])
    stalled, _ = run([2.0] * 9 + [60.0])  # one request in ten stalls
    assert metric("resident_gtexels_s", stalled) < 0.8 * metric("resident_gtexels_s", steady)
    assert metric("resident_p95_ms", stalled) > 10 * metric("resident_p95_ms", steady)
    assert metric("file_p95_ms", stalled) == metric("resident_p95_ms", stalled)


def test_p95_over_all_values():
    values = list(range(1, 101))
    assert core.stat_p95(values) == pytest.approx(np.percentile(values, 95))


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(10)
    for seed in range(2000):
        r = core.Reservoir(seed, 1)
        for i in range(10):
            r.offer(0, i, i)
        counts[r.samples()[0][0]] += 1
    assert counts.min() > 120 and counts.max() < 280
    a, b = core.Reservoir(9, 2), core.Reservoir(9, 2)
    for i in range(50):
        a.offer(i % 2, i, i)
        b.offer(i % 2, i, i)
    assert a.samples() == b.samples() and len(a.samples()) == 4


def test_union_and_gaps():
    busy = trace.union([(0, 2), (1, 3), (5, 6), (-1, 0.5), (9, 12)], 0, 10)
    assert busy == [(0, 3), (5, 6), (9, 10)]
    assert trace.gaps(busy, 0, 10) == [(3, 5), (6, 9)]
    spans = {"outer": ([0], [10]), "inner": ([3.5], [4.5])}
    assert trace.label_of(4, spans) == "inner" and trace.label_of(7, spans) == "outer"
    assert trace.label_of(11, spans) == trace.OUTSIDE


def test_kernel_time_is_a_union():
    s = trace.Summary(window_s=1, busy_s=1, device_ops={"a": 3e-6, "b": 2e-6}, idle={},
                      intervals={"ub::k<1>": [(0, 3)], "ub::k<2>": [(2, 4)], "other": [(10, 20)]}, lo=0, hi=100)
    assert s.kernel_s(r"ub::k") == pytest.approx(4e-6)
    assert s.breakdown()["device_ops"] == [["a", 3e-6], ["b", 2e-6]]
