"""resident_gtexels_s: the texels of every request completed in the
window (16 a block) over the window's seconds on the host clock, from the
first call to the synchronize after the last."""


def read(record):
    return record.texels / record.window_s / 1e9
