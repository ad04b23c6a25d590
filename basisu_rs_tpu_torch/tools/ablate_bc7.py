"""Stage-ablation timing of K1 (UASTC -> BC7) on the card: T1.

    python -m basisu_rs_tpu_torch.tools.ablate_bc7 [mode ...]

Counterpart of `tools/ablate_bc7.py:109-199`: the golden `bc7_in` blocks
tiled 4096 times, split by UASTC mode (default modes 9, 2, 3, 4, 1), and
for each mode every stage of `ops/bc7_stages.py` that is instantiated for
it, timed as one launch of its kernel `bc7_stage_kernel<M, S>` over the
mode's blocks.  Each line gives Mblocks/s and microseconds a launch from
device time (CUDA events around LAUNCHES launches on a stream that a sleep
kernel holds while the host enqueues them, median of REPS:
`utils/profiling.event_times_ms`), and the
launch's HBM bound: 20 bytes a block (16 in, 4 out) at 3.35 TB/s.  The
`pbit` stage of a 2-subset mode XORs one search result twice, so its
checksum is 0 and the compiler drops the search: it times no search, as on
the TPU.  `permute_invert` is timed only for the multi-subset modes, as the
TPU tool's `main` does (`:197`); mode 1's kernel exists (its one-pattern
family) and `time_stage` times it on request.  Importing this module runs
nothing; the timing needs a card.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from ..base import resolve_device
from ..ops import bc7_stages
from ..ops.dispatch import block_modes
from ..tables import MODES
from ..utils.profiling import HBM_BYTES_PER_S, event_times_ms

FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "golden_blocks.npz"
DEFAULT_MODES = (9, 2, 3, 4, 1)
TILES = 1 << 12
BLOCK_BYTES = 20  # 16 in, a 4-byte checksum out
LAUNCHES = 20
REPS = 5
LABELS = {
    "full": "full kernel",
    "decode_endpoints": "decode_endpoints",
    "decode_weights": "decode_weights",
    "decode_fields": "decode_fields (all)",
    "pbit": "pbit search (fake endpoints)",
    "permute_invert": "fields+permute+invert",
}


def mode_blocks(modes, device) -> dict:
    """{mode: uint8 [n, 16] blocks on device}: the golden bc7_in tiled TILES
    times, split by mode."""
    blocks = torch.from_numpy(np.tile(np.load(FIXTURE)["bc7_in"], (TILES, 1))).to(device)
    all_modes = block_modes(blocks)
    return {m: blocks[all_modes == m] for m in modes}


def device_ms(fn) -> float:
    """Device time of one fn() launch in ms: CUDA events around LAUNCHES
    calls on a preloaded stream, divided by LAUNCHES, median of REPS."""
    return statistics.median(event_times_ms(fn, REPS, LAUNCHES, preload=True))


def bound_ms(n_blocks: int) -> float:
    return n_blocks * BLOCK_BYTES / HBM_BYTES_PER_S * 1e3


def time_stage(mode: int, stage: str, blocks, log=print) -> dict:
    """Time one launch of (mode, stage) over blocks (contiguous uint8
    [n, 16] of that mode on the card): {"blocks", "ms", "bound_ms", "out"},
    where out holds the checksums of the last timed launch; logs one line."""
    k = bc7_stages.stage_kernel(mode, stage)
    n = blocks.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=blocks.device)
    k(blocks, out)  # warm-up
    ms = device_ms(lambda: k(blocks, out))
    b = bound_ms(n)
    log(f"  {LABELS[stage]:34s}: {n / ms / 1e3:8.1f} Mblocks/s  ({ms * 1e3:7.2f} us/launch; HBM bound "
        f"{b * 1e3:6.2f} us at {BLOCK_BYTES} B a block)")
    return dict(blocks=n, ms=ms, bound_ms=b, out=out)


def run(modes=DEFAULT_MODES, device="cuda", log=print, inputs=None) -> dict:
    """Time every instantiated stage of each mode (permute_invert only for
    multi-subset modes) over inputs[mode] (contiguous uint8 [n, 16] blocks
    of that mode on the card; by default mode_blocks()).  Returns
    {(mode, stage): time_stage(...)} and logs one line a stage."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the stage timings are device times: they need a CUDA device")
    if inputs is None:
        inputs = mode_blocks(modes, device)
    results = {}
    for m in modes:
        cfg, blocks = MODES[m], inputs[m]
        n = blocks.shape[0]
        log(f"mode {m} (fmt={cfg.format} subsets={cfg.subset_count} wb={cfg.weight_bits} "
            f"range={cfg.endpoint_range_index} E={cfg.endpoint_count}), {n} blocks")
        for stage in bc7_stages.STAGES:
            if m in bc7_stages.STAGE_MODES[stage] and (stage != "permute_invert" or cfg.subset_count > 1):
                results[(m, stage)] = time_stage(m, stage, blocks, log)
    return results


def main(argv=None) -> int:
    modes = [int(m) for m in (sys.argv[1:] if argv is None else argv)] or list(DEFAULT_MODES)
    run(modes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
