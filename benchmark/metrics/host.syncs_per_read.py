"""host.syncs_per_read: host reads that wait for the card, a file read (the
program's counter `host_syncs`, one at each such read: the partition's
counts, the error check's `nonzero`, an index check's `.tolist()`), over
every read of the window."""

from benchmark.metrics import _recorder

_recorder.start()

# an ETC1S read waits for the card nowhere: it reads 0 with a card as without one
CPU_READS = "zero"


def read(record):
    return _recorder.per_call(record, "host_syncs")
