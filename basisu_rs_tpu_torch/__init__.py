"""PyTorch + CUDA port of the Basis Universal batch transcoder.

The JAX package `basisu_rs_tpu` is the reference this port is held against.
The port carries every UASTC path, to BC7, ASTC, RGBA, ETC1 and ETC2, for
loose blocks and for UASTC .basis files: a mode partition on the device and
one hand-written sm_90a CUDA kernel launch per UASTC mode and target
(`csrc/uastc_{bc7,astc,rgba,etc1,etc2}.cu`), with a plain PyTorch version of
each kernel (`ops/{bc7,astc,rgba,etc}.py`) for tensors on the CPU.  ETC1S
files are not ported yet.  Every entry point
runs on the card unless called with `device="cpu"`.  This package imports
torch and numpy, never JAX, and nothing of the JAX package.
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
from .container import read_to_astc, read_to_bc7, read_to_etc1, read_to_etc2, read_to_rgba, read_to_uastc

__all__ = [
    "BasisError",
    "Image",
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
