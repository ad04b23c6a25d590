"""container.crc_fold_pct: the share of the bytes the host CRC-16 read that
its carry-less-multiply fold consumed (the program's counters
`crc_fold_bytes` over `crc_bytes`, container/crc.py), in percent, over the
window; nothing where the program counts no CRC bytes."""

from benchmark.metrics import _recorder

_recorder.start()


def read(record):
    rec = _recorder.records()
    total = rec.total("crc_bytes") if rec is not None else 0
    return 100.0 * rec.total("crc_fold_bytes") / total if total else None
