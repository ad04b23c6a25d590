"""etc1s.pack_ms: host-clock milliseconds a request packs the ETC1S
codebooks into words and copies them to the card (the program's span
`etc1s.pack`), over every request of the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    return _recorder.ms_per_call(record, "etc1s.pack")
