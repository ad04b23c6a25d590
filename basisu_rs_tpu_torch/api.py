"""Public API of the PyTorch port (counterpart of `basisu_rs_tpu/api.py`).

Block-level functions raise `BasisError` where the reference returns `Err`
(invalid mode index, invalid pattern index).  The batch function takes
numpy or torch uint8 `[N, 16]` blocks and returns torch tensors.  Every
entry point runs on `device="cuda"` unless the caller asks for another
device; with no card it raises rather than falling back to the CPU, where
the plain versions run only when asked for with `device="cpu"`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .ops.dispatch import INVALID_MODE, block_modes, check_target, transcode_blocks
from .utils.profiling import count, span


class BasisError(ValueError):
    """Transcode/parse failure (reference: Error = String, src/lib.rs:26)."""


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises for "cuda" when no
    card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return device


@dataclass
class Image:
    """Decoded image plane (reference: src/lib.rs:63-79).

    `stride` is in elements of `data` per row; `data` is a flat torch tensor
    on the device the call ran on (uint8 bytes for block formats and RGBA
    byte output, uint32 for packed RGBA texel words).
    """

    w: int
    h: int
    stride: int
    data: torch.Tensor

    def into_rgba_bytes(self) -> "Image":
        """Image of packed RGBA u32 texel words -> Image of RGBA bytes
        (reference: Image<Color32>::into_rgba_bytes, src/lib.rs:70-79).
        Byte images pass through unchanged."""
        if self.data.dtype == torch.uint8:
            return self
        data = self.data.contiguous().view(torch.uint8).reshape(-1)
        return Image(w=self.w, h=self.h, stride=self.stride * 4, data=data)


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the numpy array a, without a copy; a may be a
    read-only view of the caller's bytes, which the port only reads."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def block_tensor(blocks) -> torch.Tensor:
    """uint8 [N,16] UASTC blocks (numpy or torch) as a contiguous torch
    tensor where they lie: numpy arrays become CPU tensors over the same
    memory where they can."""
    t = blocks if isinstance(blocks, torch.Tensor) else host_tensor(np.ascontiguousarray(blocks, np.uint8))
    if t.dtype != torch.uint8:
        raise ValueError(f"UASTC blocks must be uint8, got {t.dtype}")
    return t.reshape(-1, 16).contiguous()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """t on `device` (t itself where it lies there).  A copy from the host
    to another device runs under the `parallel.h2d` span and adds its bytes
    to the `h2d_bytes` counter; from pageable memory it holds the host until
    it is done."""
    if t.device.type != "cpu" or torch.device(device).type == "cpu":
        return t.to(device)
    with span("parallel.h2d"):
        count("h2d_bytes", t.numel() * t.element_size())
        return t.to(device)


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
            # the reference's two block-level failures (uastc.rs:336, :364)
            count("host_syncs")
            if int(block_modes(block)[0]) == INVALID_MODE:
                raise BasisError("invalid mode index")
            raise BasisError("block pattern is not valid")
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
