"""resident_p95_ms: the 95th percentile of the latency of every request in
the window, from an event recorded before the call to one recorded after
it, on the card's clock (CUDA events), then a synchronize."""

from benchmark.core import stat_p95


def read(record):
    return stat_p95(record.latencies_ms) if record.latencies_ms else None
