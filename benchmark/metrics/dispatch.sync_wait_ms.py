"""dispatch.sync_wait_ms: host-clock milliseconds a request waits for the
partition's 20 mode counts (the program's span `dispatch.counts`, the
`.tolist()` that is the transcode's one host sync), over every request of
the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    return _recorder.ms_per_call(record, "dispatch.counts")
