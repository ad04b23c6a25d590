"""Multi-device and multi-host parallel execution (port of
`basisu_rs_tpu/parallel`)."""

from .mesh import (
    make_mesh,
    shard_blocks,
    sharded_etc1s_transcode,
    sharded_transcode,
    sharded_transcode_step,
)
from .multihost import global_stats, initialize, shard_corpus

__all__ = [
    "global_stats",
    "initialize",
    "make_mesh",
    "shard_blocks",
    "shard_corpus",
    "sharded_etc1s_transcode",
    "sharded_transcode",
    "sharded_transcode_step",
]
