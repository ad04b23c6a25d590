"""PyTorch + CUDA port of the Basis Universal batch transcoder.

The JAX package `basisu_rs_tpu` is the reference this port is held against.
So far the port carries the main path, UASTC -> BC7: a mode partition on the
device and one hand-written sm_90a CUDA kernel launch per UASTC mode
(`csrc/uastc_bc7.cu`), with a plain PyTorch version of the same kernel
(`ops/bc7.py`) for tensors on the CPU.  This package imports torch and
numpy, never JAX.
"""

from .api import BasisError, transcode_uastc_block_to_bc7, transcode_uastc_blocks

__all__ = ["BasisError", "transcode_uastc_block_to_bc7", "transcode_uastc_blocks"]
