"""dispatch.launches_per_call: kernel launches a request (the program's
counter `launches`, one a launch of a CUDA kernel; a plain-version call on
the CPU is none), over every request of the window."""

from benchmark.metrics import _recorder

_recorder.start()

# the plain versions that run without a card launch no CUDA kernel
CPU_READS = "zero"


def read(record):
    return _recorder.per_call(record, "launches")
