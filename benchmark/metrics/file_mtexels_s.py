"""file_mtexels_s: the texels of every file read in the window (every mip
level's width x height) over the window's seconds on the host clock, from
the first call to the synchronize after the last."""


def read(record):
    return record.texels / record.window_s / 1e6
