"""dispatch.enqueue_ms: host-clock milliseconds a request spends enqueueing
the UASTC partition and its launches: the program's spans `dispatch.groups`
(the modes, the argsort and the bincount) and `dispatch.launch` (one launch
a present mode), over every request of the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    return _recorder.ms_per_call(record, "dispatch.groups", "dispatch.launch")
