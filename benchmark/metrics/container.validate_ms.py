"""container.validate_ms: host-clock milliseconds a file read spends
validating the file (the program's span `container.validate`: the header,
both CRC-16s and the slice descriptors), over every read of the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    return _recorder.ms_per_call(record, "container.validate")
