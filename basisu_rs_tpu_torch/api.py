"""Public API of the PyTorch port (counterpart of `basisu_rs_tpu/api.py`).

Block-level functions raise `BasisError` where the reference returns `Err`
(invalid mode index, invalid pattern index).  The batch function takes
numpy or torch uint8 `[N, 16]` blocks and returns torch tensors.  Every
entry point runs on `device="cuda"` unless the caller asks for another
device; with no card it raises rather than falling back to the CPU, where
the plain versions run only when asked for with `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BasisError, Image, block_tensor, resolve_device, to_device  # noqa: F401 (Image: public, re-exported)
from .ops.dispatch import check_target, raise_block_error, transcode_blocks
from .utils.profiling import count, span


def _as_blocks(blocks, device) -> torch.Tensor:
    device = resolve_device(device)
    return to_device(block_tensor(blocks), device)


def transcode_uastc_blocks(blocks, target: str, device="cuda"):
    """Batch transcode: uint8 [N,16] UASTC blocks (numpy or torch) ->
    (out, err bool [N]) as torch tensors on `device`.  out is uint8 block
    bytes for "bc7", "astc" and "etc2" ([N,16]) and "etc1" ([N,8]), and
    uint32 [N,16] packed RGBA texel words for "rgba"."""
    with span("api.transcode"):
        check_target(target)
        return transcode_blocks(_as_blocks(blocks, device), target)


def _one_block(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu":
            count("host_syncs")
        arr = data.detach().cpu().numpy()
    elif isinstance(data, np.ndarray):
        arr = data
    else:
        arr = np.frombuffer(bytes(data), np.uint8)
    arr = arr.astype(np.uint8).reshape(-1)
    if arr.size != 16:
        raise BasisError("UASTC block must be 16 bytes")
    return arr[None, :]


def _single(data, target: str, device) -> np.ndarray:
    with span("api.block"):
        block = _as_blocks(_one_block(data), device)
        out, err = transcode_blocks(block, target)
        count("host_syncs")
        if bool(err[0]):
            count("host_syncs")
            raise_block_error(block)
        count("host_syncs")
        return out[0].cpu().numpy()


def unpack_uastc_block_to_rgba(data, device="cuda") -> np.ndarray:
    """16-byte UASTC block -> 16 packed RGBA u32 texels (lib.rs:29-31)."""
    return _single(data, "rgba", device)


def transcode_uastc_block_to_astc(data, device="cuda") -> bytes:
    """16-byte UASTC block -> 16-byte ASTC 4x4 block."""
    return _single(data, "astc", device).tobytes()


def transcode_uastc_block_to_bc7(data, device="cuda") -> bytes:
    """16-byte UASTC block -> 16-byte BC7 block (lib.rs:29-79)."""
    return _single(data, "bc7", device).tobytes()


def transcode_uastc_block_to_etc1(data, device="cuda") -> bytes:
    """16-byte UASTC block -> 8-byte ETC1 block."""
    return _single(data, "etc1", device).tobytes()


def transcode_uastc_block_to_etc2(data, device="cuda") -> bytes:
    """16-byte UASTC block -> 16-byte ETC2 RGBA block (EAC alpha, then ETC1)."""
    return _single(data, "etc2", device).tobytes()
