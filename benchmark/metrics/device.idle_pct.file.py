"""device.idle_pct.file: the share of the traced window in which no
kernel or copy ran on the card (1 - the union of the device's intervals
over the window), in the file cells."""


def read(record):
    t = record.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
