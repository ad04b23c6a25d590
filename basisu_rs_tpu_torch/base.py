"""The port's base: its error, its image type, where tensors lie, and how a
batch splits into shards.

Every layer imports these names from here, and this module imports
nothing of the package but `utils/profiling.py`, so no layer has to
import the entry module (`api.py`) that sits above it.  A shard is a
contiguous run of rows that runs on one device; the one-device entries
are the one-shard case of the same code (`ops/dispatch.py`
`transcode_shards`, `ops/etc1s.py` `run_etc1s`).
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .utils.profiling import count, span


class BasisError(ValueError):
    """Transcode/parse failure (reference: Error = String, src/lib.rs:26)."""


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


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on, a card with its index (a
    shard's rows are written in place only where its device equals the
    result's, and torch.device("cuda") is not torch.device("cuda", 0));
    raises for "cuda" when no card is present."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


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


def shard_bounds(n: int, parts: int) -> list:
    """(start, end) of each of `parts` contiguous shards of n rows: shard k
    takes rows [k * per, (k + 1) * per) with per = ceil(n / parts)."""
    per = -(-n // parts)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(parts)]


def on_device(device):
    """Make `device` current for the work enqueued under it (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_shard(device, views: tuple, fn) -> None:
    """Run a shard's fn(*outs) under `device`: outs are `views` (rows of the
    result) when the shard lies on the result's device, else tensors of
    their shapes on the shard's device, copied into the views afterwards."""
    with on_device(device):
        if device == views[0].device:
            fn(*views)
            return
        local = [torch.empty_like(v, device=device) for v in views]
        fn(*local)
        for v, t in zip(views, local):
            v.copy_(t)
