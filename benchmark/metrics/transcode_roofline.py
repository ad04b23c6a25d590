"""transcode_roofline: the least time the card's HBM needs for the cell's
transcode work over the time the program's transcode kernels took, in the
traced part of the window.  The bytes come from the cell's shapes alone
(`hbm_bytes_per_block` of the configuration: each input byte read once,
each output byte written once), so the yardstick does not change with the
kernels; the kernels are found by name in the device trace."""

import json
from pathlib import Path

KERNELS = r"uastc_kernel|etc1s_kernel"
PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def read(record):
    if record.trace is None or not record.trace_blocks:
        return None
    peak = json.loads(PEAKS.read_text()).get(record.device_kind, {}).get("hbm_bytes_per_s")
    kernel_s = record.trace.kernel_s(KERNELS)
    if not peak or kernel_s <= 0:
        return None
    return 100.0 * record.trace_blocks * record.config["hbm_bytes_per_block"] / peak / kernel_s
