"""Batch transcode dispatch: mode partition on the device + one K1 launch
per present UASTC mode.

Port of `basisu_rs_tpu/ops/dispatch.py` for target "bc7".  The partition
runs where the blocks are: the mode of every block is MODE_LUT[b0 & 0x7F],
a stable argsort groups the block indices by mode, and a bincount sizes the
groups; reading the 20 counts is the one host sync.  Each present mode then
gets one launch that reads and writes its rows in place through its slice of
the sorted indices, so there is no gather or scatter pass.  Blocks of the
invalid mode 19 come out zero with err set.  Groups are not padded: the
power-of-two buckets of the JAX package only bound its recompiles.
"""

from __future__ import annotations

import torch

from ..tables import INVALID_MODE, device_tables
from .kernels import bc7_mode_kernel

# ROADMAP.md Queue 1 items that port the other targets.
_NOT_PORTED = {"rgba": 7, "astc": 7, "etc1": 8, "etc2": 8}


def check_target(target: str) -> None:
    if target == "bc7":
        return
    if target in _NOT_PORTED:
        raise NotImplementedError(
            f"target {target!r} is not ported to PyTorch yet "
            f"(ROADMAP.md Queue 1 item {_NOT_PORTED[target]})"
        )
    raise NotImplementedError(f"unknown target {target!r}; the port has 'bc7' only")


def block_modes(blocks: torch.Tensor) -> torch.Tensor:
    """uint8 [N,16] blocks -> uint8 [N] UASTC mode id (0..18, 19 = invalid)."""
    lut = device_tables(blocks.device)["MODE_LUT"]
    return lut[(blocks[:, 0] & 0x7F).to(torch.int64)]


def transcode_blocks(blocks: torch.Tensor, target: str = "bc7"):
    """uint8 [N,16] UASTC blocks -> (out uint8 [N,16], err bool [N]) on the
    blocks' device.  err marks an invalid mode or pattern index."""
    check_target(target)
    n = blocks.shape[0]
    modes = block_modes(blocks)
    order = torch.argsort(modes, stable=True)
    counts = torch.bincount(modes, minlength=INVALID_MODE + 1).tolist()
    out = torch.empty_like(blocks)
    err = torch.empty(n, dtype=torch.bool, device=blocks.device)
    start = 0
    for mode, count in enumerate(counts):
        if count:
            idx = order[start : start + count]
            if mode == INVALID_MODE:
                out[idx] = 0
                err[idx] = True
            else:
                bc7_mode_kernel(mode)(blocks, idx, out, err)
        start += count
    return out, err
