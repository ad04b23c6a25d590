"""Batch transcode dispatch: mode partition on the device + one kernel launch
per present UASTC mode.

Port of `basisu_rs_tpu/ops/dispatch.py` for every UASTC target: "bc7",
"astc", "rgba", "etc1" and "etc2".  The partition runs where the blocks
are: the mode of every block is MODE_LUT[b0 & 0x7F], a stable argsort
groups the block indices by mode, and a bincount sizes the groups; on a
card the bincount reads the modes' max back to the host, one host sync,
and reading the 20 counts is the other.  Each present mode then gets one launch
that reads and writes its rows in place through its slice of the sorted
indices, so there is no gather or scatter pass; for the targets in
`kernels.CHAINED` (K1) each launch after the first is chained to the one
before it, which writes other rows and none that it reads.  Blocks of the
invalid mode 19 come out zero with err set.
Groups are not padded: the power-of-two buckets of the JAX package only
bound its recompiles.
"""

from __future__ import annotations

import torch

from ..tables import INVALID_MODE, device_tables
from ..utils.profiling import count, count_elapsed_ns, cuda_mark, span
from .kernels import CHAINED, OUT_BYTES, TARGETS, mode_kernel


def check_target(target: str) -> None:
    if target not in TARGETS:
        raise NotImplementedError(f"unknown target {target!r}; the port has {', '.join(map(repr, TARGETS))}")


def block_modes(blocks: torch.Tensor) -> torch.Tensor:
    """uint8 [N,16] blocks -> uint8 [N] UASTC mode id (0..18, 19 = invalid)."""
    lut = device_tables(blocks.device)["MODE_LUT"]
    return lut[(blocks[:, 0] & 0x7F).to(torch.int64)]


def mode_groups(blocks: torch.Tensor):
    """(order, counts) of uint8 [N,16] blocks, computed where the blocks
    lie: the block indices sorted by mode (stable) and the int64 [20]
    per-mode counts.  On a card, torch.bincount reads the modes' max back
    to size its bins, a host sync that waits for the modes and the sort
    (span `dispatch.bincount`)."""
    modes = block_modes(blocks)
    order = torch.argsort(modes, stable=True)
    with span("dispatch.bincount"):
        count("host_syncs")
        counts = torch.bincount(modes, minlength=INVALID_MODE + 1)
    return order, counts


def partition(blocks: torch.Tensor):
    """mode_groups() with the 20 counts read back to the host (a host sync;
    mode_groups' bincount is the other).  Spans: `dispatch.groups` (the
    enqueue, and the bincount's wait), `dispatch.counts` (the wait for the
    counts); with the recorder on, the card's time for mode_groups' work
    goes to the `partition_device_ns` counter, read after the counts' own
    sync."""
    with span("dispatch.groups"):
        start = cuda_mark(blocks.device)
        order, counts = mode_groups(blocks)
        end = cuda_mark(blocks.device)
    with span("dispatch.counts"):
        count("host_syncs")
        counts = counts.tolist()
    count_elapsed_ns("partition_device_ns", start, end)
    return order, counts


def dispatch(blocks: torch.Tensor, target: str, order: torch.Tensor, counts, out=None, err=None) -> tuple:
    """One launch per present mode over partition()'s groups, enqueued
    without a sync; returns (out, err) as transcode_blocks does.  out
    (uint8 [N, OUT_BYTES[target]]) and err (bool [N]) are written in place
    when given, as the kernel wrappers check them, else allocated.  Span:
    `dispatch.launch`."""
    with span("dispatch.launch"):
        n = blocks.shape[0]
        if out is None:
            out = torch.empty(n, OUT_BYTES[target], dtype=torch.uint8, device=blocks.device)
        if err is None:
            err = torch.empty(n, dtype=torch.bool, device=blocks.device)
        start, chain = 0, False
        for mode, rows in enumerate(counts):
            if rows:
                idx = order[start : start + rows]
                if mode == INVALID_MODE:
                    # index_fill_ takes the value as a scalar: an assignment
                    # through the index would copy it from pageable host memory,
                    # which waits for the stream to drain
                    out.index_fill_(0, idx, 0)
                    err.index_fill_(0, idx, True)
                else:
                    # idx is a slice of the argsort of the N rows: in range by construction
                    mode_kernel(target, mode)(blocks, idx, out, err, check_index=False, chain=chain)
                    chain = target in CHAINED
            start += rows
        return (out.view(torch.uint32) if target == "rgba" else out), err


def transcode_blocks(blocks: torch.Tensor, target: str = "bc7"):
    """uint8 [N,16] UASTC blocks -> (out, err bool [N]) on the blocks'
    device.  out is uint8 [N, OUT_BYTES[target]] block bytes for "bc7",
    "astc" (16), "etc1" (8) and "etc2" (16: the EAC alpha block, then the
    ETC1 block), and for "rgba" the torch.uint32 [N,16] view of the
    kernel's uint8 [N,64] texel rows (little-endian RGBA words, as the JAX
    package's uint32 [N,16]).
    err marks an invalid mode or pattern index."""
    check_target(target)
    return dispatch(blocks, target, *partition(blocks))
