"""parallel.h2d_gb_s: the bytes the program copies from the host to the
card (counter `h2d_bytes`) over the host-clock seconds of those copies
(span `parallel.h2d`, which a copy from pageable memory holds until it is
done), over every read of the window, in GB/s."""

from benchmark.metrics import _recorder

_recorder.start()

# without a card nothing is copied to one: no seconds of copies, no reading
CPU_READS = "none"


def read(record):
    rec = _recorder.records()
    seconds = rec.seconds("parallel.h2d") if rec is not None else 0.0
    return rec.total("h2d_bytes") / seconds / 1e9 if seconds else None
