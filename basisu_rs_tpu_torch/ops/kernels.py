"""K1 wrappers: the hand-written CUDA kernel of one UASTC mode, behind a
PyTorch call.

Counterpart of `basisu_rs_tpu/ops/pallas_kernels.py::pallas_mode_kernel`
for target "bc7": `bc7_mode_kernel(mode)(blocks) -> (out, err)`.  Blocks
travel as uint8 `[N, 16]` rows (the same 16 bytes as the JAX package's
uint32 `[N, 4]` words; torch's uint32 has too few operators to be a word
type), and an optional int64 `index` names the rows of that mode, which the
kernel reads and writes in place.

A tensor on the CPU goes to the plain version (`ops/bc7.py`); a CUDA tensor
goes to the kernel, or the call raises.  Each wrapper counts its kernel
launches (`launches`) and its plain-version calls (`plain_calls`).
"""

from __future__ import annotations

import torch

from . import bc7, build

N_MODES = 19


class Bc7ModeKernel:
    """UASTC mode `mode` -> BC7, one launch of `uastc_bc7_kernel<mode>`."""

    def __init__(self, mode: int):
        self.mode = mode
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, blocks, index=None, out=None, err=None):
        """Transcode blocks[index] (every row when index is None) into
        out[index] / err[index]; allocates out/err (torch.empty) when not
        given.  Rows outside `index` are left as they were.  Every index
        value must lie in [0, N).  Returns (out uint8 [N,16], err bool [N])."""
        dev = blocks.device
        if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != 16:
            raise ValueError(f"blocks must be uint8 [N, 16], got {blocks.dtype} {tuple(blocks.shape)}")
        if not blocks.is_contiguous():
            raise ValueError("blocks must be contiguous")
        n_rows = blocks.shape[0]
        if out is None:
            out = torch.empty_like(blocks)
        if err is None:
            err = torch.empty(n_rows, dtype=torch.bool, device=dev)
        if out.dtype != torch.uint8 or out.shape != blocks.shape or out.device != dev or not out.is_contiguous():
            raise ValueError("out must be a contiguous uint8 tensor shaped and placed like blocks")
        if err.dtype != torch.bool or err.shape != (n_rows,) or err.device != dev or not err.is_contiguous():
            raise ValueError("err must be a contiguous bool [N] tensor on the blocks' device")
        if index is not None:
            if index.dtype != torch.int64 or index.dim() != 1 or index.device != dev or not index.is_contiguous():
                raise ValueError("index must be a contiguous int64 [M] tensor on the blocks' device")
        n = n_rows if index is None else index.shape[0]

        if n == 0:
            return out, err
        if dev.type == "cpu":
            self.plain_calls += 1
            bc7.transcode_rows(self.mode, blocks, index, out, err)
        elif dev.type == "cuda":
            self._launch(blocks, index, n, out, err)
        else:
            raise ValueError(f"no BC7 kernel for device {dev}")
        return out, err

    def _launch(self, blocks, index, n, out, err) -> None:
        if n >= 2**31:
            raise ValueError(f"{n} blocks exceed one launch (2^31 - 1)")
        for t in (blocks, out):
            if t.data_ptr() % 16:
                raise ValueError("blocks and out must be 16-byte aligned")
        lib = build.load()
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            rc = lib.uastc_bc7_launch(
                self.mode,
                blocks.data_ptr(),
                None if index is None else index.data_ptr(),
                n,
                out.data_ptr(),
                err.data_ptr(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"uastc_bc7_kernel<{self.mode}> launch failed: cudaError_t {rc}")
        self.launches += 1


_KERNELS = tuple(Bc7ModeKernel(m) for m in range(N_MODES))


def bc7_mode_kernel(mode: int) -> Bc7ModeKernel:
    return _KERNELS[mode]


def launch_counts() -> list:
    return [k.launches for k in _KERNELS]


def plain_call_counts() -> list:
    return [k.plain_calls for k in _KERNELS]


def reset_counts() -> None:
    for k in _KERNELS:
        k.launches = 0
        k.plain_calls = 0
