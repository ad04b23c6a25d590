"""etc1s.index_check_ms: host-clock milliseconds a request spends in the
ETC1S wrapper's index check (the program's span `etc1s.index_check`: the
max-reduces and the `.tolist()` that waits for them), over every request
of the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    return _recorder.ms_per_call(record, "etc1s.index_check")
