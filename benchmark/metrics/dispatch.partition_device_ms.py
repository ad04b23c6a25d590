"""dispatch.partition_device_ms: the card's milliseconds a request for the
partition's work (the modes, the argsort, the bincount): a pair of CUDA
events the program records around it and reads after the counts' own sync
(counter `partition_device_ns`), over every request of the window.  With
no card there are no events and nothing to read."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    rec = _recorder.records()
    if rec is None or not record.calls or not any(name == "partition_device_ns" for _r, name in rec.counts):
        return None
    return rec.total("partition_device_ns") / record.calls / 1e6
