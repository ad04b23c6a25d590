"""Public API of the PyTorch port (counterpart of `basisu_rs_tpu/api.py`).

Block-level functions raise `BasisError` where the reference returns `Err`
(invalid mode index, invalid pattern index).  The batch function takes
numpy or torch uint8 `[N, 16]` blocks and returns torch tensors on the
requested device.  Only the "bc7" target is ported so far.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.dispatch import INVALID_MODE, block_modes, check_target, transcode_blocks


class BasisError(ValueError):
    """Transcode/parse failure (reference: Error = String, src/lib.rs:26)."""


def _as_blocks(blocks, device) -> torch.Tensor:
    if isinstance(blocks, torch.Tensor):
        t = blocks
    else:
        t = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8))
    if device is not None:
        t = t.to(device)
    if t.dtype != torch.uint8:
        raise ValueError(f"UASTC blocks must be uint8, got {t.dtype}")
    return t.reshape(-1, 16).contiguous()


def transcode_uastc_blocks(blocks, target: str, device=None):
    """Batch transcode: uint8 [N,16] UASTC blocks (numpy or torch) ->
    (out uint8 [N,16], err bool [N]) as torch tensors on `device` (default:
    the tensor's own device; CPU for numpy input)."""
    check_target(target)
    return transcode_blocks(_as_blocks(blocks, device), target)


def _one_block(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        arr = data.detach().cpu().numpy()
    elif isinstance(data, np.ndarray):
        arr = data
    else:
        arr = np.frombuffer(bytes(data), np.uint8)
    arr = arr.astype(np.uint8).reshape(-1)
    if arr.size != 16:
        raise BasisError("UASTC block must be 16 bytes")
    return arr[None, :]


def _single(data, target: str, device):
    block = _as_blocks(_one_block(data), device)
    out, err = transcode_blocks(block, target)
    if bool(err[0]):
        # the reference's two block-level failures (uastc.rs:336, :364)
        if int(block_modes(block)[0]) == INVALID_MODE:
            raise BasisError("invalid mode index")
        raise BasisError("block pattern is not valid")
    return out[0].cpu().numpy()


def transcode_uastc_block_to_bc7(data, device=None) -> bytes:
    """16-byte UASTC block -> 16-byte BC7 block (lib.rs:29-79)."""
    return _single(data, "bc7", device).tobytes()
