"""Batch transcode dispatch over a list of shards: for BC7 on a card one
launch a shard, for the other targets a mode partition on the device and
one kernel launch per present UASTC mode.

Port of `basisu_rs_tpu/ops/dispatch.py` for every UASTC target: "bc7",
"astc", "rgba", "etc1" and "etc2".

BC7 (`kernels.TILED`): each shard goes to `kernels.tile_kernel("bc7")`,
whose one launch of `uastc_kernel_tiles<Bc7>` groups each tile of 4,096
contiguous blocks by mode in shared memory, so there is no index, no
device-wide sort and no host read; a CPU shard takes the wrapper's plain
path, the partition below and each present mode's plain version.

The other targets partition where the blocks are: the mode of every block
is MODE_LUT[b0 & 0x7F], a stable argsort groups the block indices by mode,
and a bincount sizes the groups; on a card the bincount reads the modes'
max back to the host, one host sync, and reading the 20 counts is the
other.  Each present mode then gets one launch that reads and writes its
rows in place through its slice of the sorted indices, so there is no
gather or scatter pass.  Blocks of the invalid mode 19 come out zero with
err set, on either path.  Groups are not padded: the power-of-two buckets
of the JAX package only bound its recompiles.

A batch is a list of shards, each a uint8 [N_k,16] tensor on its own
device (`transcode_shards`); one device is the one-shard case
(`transcode_blocks`), and `parallel/mesh.py` splits a batch over a mesh.
"""

from __future__ import annotations

from functools import partial

import torch

from ..base import BasisError, on_device, run_shard
from ..tables import INVALID_MODE, device_tables
from ..utils.profiling import count, count_elapsed_ns, cuda_mark, span
from .kernels import OUT_BYTES, TARGETS, TILED, mode_kernel, tile_kernel


def check_target(target: str) -> None:
    if target not in TARGETS:
        raise NotImplementedError(f"unknown target {target!r}; the port has {', '.join(map(repr, TARGETS))}")


def block_modes(blocks: torch.Tensor) -> torch.Tensor:
    """uint8 [N,16] blocks -> uint8 [N] UASTC mode id (0..18, 19 = invalid)."""
    lut = device_tables(blocks.device)["MODE_LUT"]
    return lut[(blocks[:, 0] & 0x7F).to(torch.int64)]


def raise_block_error(block: torch.Tensor):
    """Raise the reference's error for a block the kernels flagged (uint8
    [1,16]): "invalid mode index" (uastc.rs:336) or "block pattern is not
    valid" (uastc.rs:364), the only two per-block Err sites.  Reads the
    block's mode back to the host."""
    if int(block_modes(block)[0]) == INVALID_MODE:
        raise BasisError("invalid mode index")
    raise BasisError("block pattern is not valid")


def _mode_groups(blocks: torch.Tensor):
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


def partition(shards) -> list:
    """(order, counts) of each uint8 [N_k,16] shard, on the shard's device:
    the block indices sorted by mode and the 20 per-mode counts read back to
    the host (a host sync a shard; each bincount's is the other).  Every
    shard's groups are enqueued before the first count is read, and every
    count is read before the first launch, so no device waits on another's
    count read (each bincount's own sync still waits for its shard's modes
    and sort).  Spans: `dispatch.groups` (the enqueue, and the bincounts'
    waits), `dispatch.counts` (the wait for the counts); with the recorder
    on, the card's time for each shard's groups goes to the
    `partition_device_ns` counter, read after the counts' own sync."""
    groups, marks = [], []
    with span("dispatch.groups"):
        for s in shards:
            with on_device(s.device):
                start = cuda_mark(s.device)
                groups.append(_mode_groups(s))
                marks.append((start, cuda_mark(s.device)))
    with span("dispatch.counts"):
        count("host_syncs", len(groups))
        counts = [c.tolist() for _, c in groups]
    for start, end in marks:
        count_elapsed_ns("partition_device_ns", start, end)
    return [(order, c) for (order, _), c in zip(groups, counts)]


def dispatch(blocks: torch.Tensor, target: str, order: torch.Tensor, counts, out=None, err=None) -> tuple:
    """One launch per present mode over one shard's (order, counts) from
    partition(), enqueued without a sync; returns (out, err) as
    transcode_blocks does.  out (uint8 [N, OUT_BYTES[target]]) and err
    (bool [N]) are written in place when given, as the kernel wrappers
    check them, else allocated.  Span: `dispatch.launch`."""
    with span("dispatch.launch"):
        n = blocks.shape[0]
        if out is None:
            out = torch.empty(n, OUT_BYTES[target], dtype=torch.uint8, device=blocks.device)
        if err is None:
            err = torch.empty(n, dtype=torch.bool, device=blocks.device)
        start = 0
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
                    mode_kernel(target, mode)(blocks, idx, out, err, check_index=False)
            start += rows
        return (out.view(torch.uint32) if target == "rgba" else out), err


def shard_groups(shards, target: str) -> list:
    """Each shard's (order, counts) from partition(), or None for every
    shard of a target in TILED, whose kernel groups its blocks itself."""
    return [None] * len(shards) if target in TILED else partition(shards)


def transcode_shard(shard, target: str, group, out, err) -> None:
    """One shard into out / err, enqueued: the tile kernel where group is
    None, else the launches of its partition's (order, counts)."""
    if group is None:
        tile_kernel(target)(shard, out, err)
    else:
        dispatch(shard, target, *group, out=out, err=err)


def transcode_shards(shards, target: str, out_device) -> tuple:
    """Transcode each uint8 [N_k,16] shard on its device, BC7 through the
    tile kernel's wrapper, another target by its partition and dispatch;
    (out, err) over every shard's rows in shard order, on out_device, as
    transcode_blocks returns them.  A shard on out_device writes straight
    into its rows of the result; another is copied there."""
    check_target(target)
    groups = shard_groups(shards, target)
    # allocated after the partition, whose temporaries are freed by then, so
    # that they and the result never hold the card's memory at once
    n = sum(s.shape[0] for s in shards)
    out = torch.empty(n, OUT_BYTES[target], dtype=torch.uint8, device=out_device)
    err = torch.empty(n, dtype=torch.bool, device=out_device)
    a = 0
    for s, group in zip(shards, groups):
        b = a + s.shape[0]
        run_shard(s.device, (out[a:b], err[a:b]), partial(transcode_shard, s, target, group))
        a = b
    return (out.view(torch.uint32) if target == "rgba" else out), err


def transcode_blocks(blocks: torch.Tensor, target: str = "bc7"):
    """uint8 [N,16] UASTC blocks -> (out, err bool [N]) on the blocks'
    device.  out is uint8 [N, OUT_BYTES[target]] block bytes for "bc7",
    "astc" (16), "etc1" (8) and "etc2" (16: the EAC alpha block, then the
    ETC1 block), and for "rgba" the torch.uint32 [N,16] view of the
    kernel's uint8 [N,64] texel rows (little-endian RGBA words, as the JAX
    package's uint32 [N,16]).
    err marks an invalid mode or pattern index."""
    return transcode_shards([blocks], target, blocks.device)
