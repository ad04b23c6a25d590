"""What the metrics that read the program's own recorder share: the spans
and counters a request of basisu_rs_tpu_torch/utils/profiling.py.

A metric module of this kind calls start() when it is loaded.  The harness
loads the per-layer metrics only for the traced run, after the cell's
set-up and before the window, so the recorder is on for that run's window
alone and what it holds is the window's.  A program without the recorder
gives no records, and every such metric then reads nothing."""

from basisu_rs_tpu_torch.utils import profiling


def start() -> None:
    """Drop what the recorder holds and turn it on (nothing where the
    program has no recorder)."""
    if hasattr(profiling, "enable"):
        profiling.clear()
        profiling.enable()


def records():
    """The recorder's records, or None where the program has no recorder or
    it recorded no span."""
    read = getattr(profiling, "records", None)
    rec = read() if read is not None else None
    return rec if rec is not None and rec.spans else None


def ms_per_call(record, *names):
    """Host-clock milliseconds a request in the spans of these names, or
    None where there is none."""
    rec = records()
    seconds = rec.seconds(*names) if rec is not None and record.calls else 0.0
    return seconds / record.calls * 1e3 if seconds else None


def per_call(record, counter):
    """A counter's total over the window a request (0 where the program
    recorded spans but never this counter), or None without records."""
    rec = records()
    return rec.total(counter) / record.calls if rec is not None and record.calls else None
