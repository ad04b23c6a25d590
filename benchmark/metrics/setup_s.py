"""setup_s: seconds from the start of the run (before its imports) to the
first measured request: imports, the program's library load or build, the
inputs drawn from the seed, and the warm-up of every shape the cell uses."""


def read(record):
    return record.setup_s
