"""frontend.root_hit_pct: the share of the Huffman symbols the C++ ETC1S
front-end decoded that its root table resolved without a subtable (the
program's counters `huff_root_symbols` over `huff_symbols`,
container/etc1s_frontend.py), in percent, over the window; nothing where
the program counts no symbols."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    rec = _recorder.records()
    total = rec.total("huff_symbols") if rec is not None else 0
    return 100.0 * rec.total("huff_root_symbols") / total if total else None
