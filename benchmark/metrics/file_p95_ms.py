"""file_p95_ms: the 95th percentile of the latency of every file read in
the window, from handing the file's bytes to the reader to its images on
the card: CUDA events around the call, on the card's clock, then a
synchronize."""

from benchmark.core import stat_p95


def read(record):
    return stat_p95(record.latencies_ms) if record.latencies_ms else None
