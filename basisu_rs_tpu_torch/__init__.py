"""PyTorch + CUDA port of the Basis Universal batch transcoder.

The JAX package `basisu_rs_tpu` is the reference this port is held against.
The port carries both source formats of the reference:
  - UASTC, to BC7, ASTC, RGBA, ETC1 and ETC2, for loose blocks and for
    .basis files: hand-written sm_90a CUDA kernels
    (`csrc/uastc_{bc7,astc,rgba,etc1,etc2}.cu`), for BC7 one launch that
    groups each tile of blocks by mode in shared memory, for the other
    targets a mode partition on the device and one launch per UASTC mode;
  - ETC1S/BasisLZ .basis files, to RGBA and ETC1: the host entropy
    front-end (C++, `container/etc1s_frontend.cpp`) and one CUDA kernel
    launch per file (`csrc/etc1s.cu`).
Each kernel has a plain PyTorch version (`ops/{bc7,astc,rgba,etc,etc1s}.py`)
for tensors on the CPU.  Every entry point runs on the card unless called
with `device="cpu"`.  This package imports torch and numpy, never JAX, and
nothing of the JAX package.
"""

from .api import (
    BasisError,
    Image,
    transcode_uastc_block_to_astc,
    transcode_uastc_block_to_bc7,
    transcode_uastc_block_to_etc1,
    transcode_uastc_block_to_etc2,
    transcode_uastc_blocks,
    unpack_uastc_block_to_rgba,
)
from .container import (
    Header,
    SliceDesc,
    read_to_astc,
    read_to_bc7,
    read_to_etc1,
    read_to_etc2,
    read_to_rgba,
    read_to_uastc,
)

__all__ = [
    "BasisError",
    "Header",
    "Image",
    "SliceDesc",
    "read_to_astc",
    "read_to_bc7",
    "read_to_etc1",
    "read_to_etc2",
    "read_to_rgba",
    "read_to_uastc",
    "transcode_uastc_block_to_astc",
    "transcode_uastc_block_to_bc7",
    "transcode_uastc_block_to_etc1",
    "transcode_uastc_block_to_etc2",
    "transcode_uastc_blocks",
    "unpack_uastc_block_to_rgba",
]
