"""frontend.decode_ns_per_block: host-clock nanoseconds a block of the ETC1S
front-end (the program's span `frontend.decode`: the decoder's codebooks
and Huffman tables, and every slice's index streams), over every file read
in the window."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    rec = _recorder.records()
    seconds = rec.seconds("frontend.decode") if rec is not None else 0.0
    return seconds / record.blocks * 1e9 if seconds and record.blocks else None
