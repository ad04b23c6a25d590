"""kernels.tile_lane_pct: the share of the BC7 tile kernel's lanes that
carried a block, in percent: 100 x the window's blocks over 32 x the
warp-rounds its launches ran (the program's counter `tile_warp_rounds`,
which the kernel adds on the card and the recorder reads when its records
are read, after the window).  The rest are the lanes of each mode's run
padded to whole warps.  Nothing without a card, where no kernel counts,
or where the program has no such counter."""

from benchmark.metrics import _recorder

_recorder.start()

# the plain path that runs without a card has no warp-rounds
CPU_READS = "none"


def read(record):
    rec = _recorder.records()
    rounds = rec.total("tile_warp_rounds") if rec is not None else 0
    return 100.0 * record.blocks / (32 * rounds) if rounds and record.blocks else None
