"""Multi-host corpus fan-out on torch.distributed.

Port of `basisu_rs_tpu/parallel/multihost.py`.  The work has no
cross-device math, so the multi-host story is work distribution: each
process takes a deterministic share of the corpus file list, transcodes it
on its own devices, and sums only scalar statistics with the others.

  - `initialize()`: torch.distributed bootstrap (a no-op for one process),
    on the gloo backend: the only traffic between processes is host
    scalars, and no block crosses a process
  - `shard_corpus(paths)`: deterministic per-process file assignment
  - `global_stats(...)`: texel and error counters summed across processes

The JAX package sends its counters as 31-bit limbs because JAX downcasts
int64; a torch int64 all-reduce is exact up to 2^63 and needs none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group at coordinator_address ("host:port") as rank
    process_id of num_processes; a no-op for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_corpus(paths: list) -> list:
    """The subset of corpus files this process owns (round-robin by index;
    deterministic across processes, no communication needed)."""
    rank, world = _rank_world()
    return [p for i, p in enumerate(paths) if i % world == rank]


def global_stats(local_texels: int, local_errors: int) -> tuple[int, int]:
    """Sum scalar counters across every process: one int64 all-reduce of a
    host tensor.  A single process never touches torch.distributed."""
    if _rank_world()[1] == 1:
        return int(local_texels), int(local_errors)
    t = torch.tensor([local_texels, local_errors], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t[0]), int(t[1])
