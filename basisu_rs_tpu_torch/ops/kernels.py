"""Kernel wrappers: the hand-written CUDA kernel of one (target, UASTC mode)
behind a PyTorch call.

Counterpart of `basisu_rs_tpu/ops/pallas_kernels.py::pallas_mode_kernel`:
`mode_kernel(target, mode)(blocks) -> (out, err)` for the targets "bc7"
(K1), "astc" (K2), "rgba" (K3), "etc1" (K4) and "etc2" (K5).  Blocks travel
as uint8 `[N, 16]` rows (the same 16 bytes as the JAX package's uint32
`[N, 4]` words; torch's uint32 has too few operators to be a word type),
the output as uint8 `[N, OUT_BYTES[target]]` rows, and an optional int64
`index` names the rows of that mode, which the kernel reads and writes in
place.  The wrapper checks that every index lies in [0, N) (one host sync)
unless the caller built the index itself and passes `check_index=False`, as
the dispatch does.

A tensor on the CPU goes to the plain version (`ops/{bc7,astc,rgba,etc}.py`);
a CUDA tensor goes to the kernel, or the call raises.  Each wrapper counts its
kernel launches (`launches`) and its plain-version calls (`plain_calls`).

`tile_kernel(target)(blocks, out, err)` (targets in `TILED`, K1) takes
blocks of every mode at once: on a card one launch of
`uastc_kernel_tiles<Op>`, each CTA of which groups its own tile of blocks by
mode in shared memory and transcodes them in whole warps of one mode; on
the CPU its plain version, the dispatch's partition and each present mode's
plain version.  With the recorder on, its kernel adds its warp-rounds to
the counter `tile_warp_rounds` on the card (`profiling.device_counter`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, device_counter, span
from . import astc, bc7, build, etc, rgba

N_MODES = 19
TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")
OUT_BYTES = {"bc7": 16, "astc": 16, "rgba": 64, "etc1": 8, "etc2": 16}
# the targets whose kernel takes every mode in one launch
TILED = frozenset(build.LAUNCH_TILES)
# the plain PyTorch version of each target's launch
PLAIN = {
    "bc7": bc7.transcode_rows,
    "astc": astc.transcode_rows,
    "rgba": rgba.transcode_rows,
    "etc1": etc.transcode_etc1_rows,
    "etc2": etc.transcode_etc2_rows,
}


def check_out_alignment(out) -> None:
    """Every kernel (K1-K9) stores an output row in the widest vectors that
    fit it: out must be min(16, out row bytes)-byte aligned."""
    align = min(16, out.shape[1])
    if out.data_ptr() % align:
        raise ValueError(f"out must be {align}-byte aligned")


def check_alignment(blocks, out) -> None:
    """The UASTC kernels load 16-byte block rows: blocks must be 16-byte
    aligned, and out as check_out_alignment says."""
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    check_out_alignment(out)


def _rows(blocks, out, err, out_bytes: int) -> tuple:
    """Check that blocks is a contiguous uint8 [N, 16] tensor, allocate out
    (uint8 [N, out_bytes]) and err (bool [N]) with torch.empty where not
    given, and check that both are contiguous on the blocks' device;
    returns (out, err)."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be uint8 [N, 16], got {blocks.dtype} {tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    n_rows, dev = blocks.shape[0], blocks.device
    if out is None:
        out = torch.empty(n_rows, out_bytes, dtype=torch.uint8, device=dev)
    if err is None:
        err = torch.empty(n_rows, dtype=torch.bool, device=dev)
    if (out.dtype != torch.uint8 or out.shape != (n_rows, out_bytes) or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint8 [N, {out_bytes}] tensor on the blocks' device")
    if err.dtype != torch.bool or err.shape != (n_rows,) or err.device != dev or not err.is_contiguous():
        raise ValueError("err must be a contiguous bool [N] tensor on the blocks' device")
    return out, err


class ModeKernel:
    """UASTC mode `mode` -> `target`, one launch of `uastc_kernel<Op<mode>>`."""

    def __init__(self, target: str, mode: int):
        self.target = target
        self.mode = mode
        self.out_bytes = OUT_BYTES[target]
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, blocks, index=None, out=None, err=None, check_index=True):
        """Transcode blocks[index] (every row when index is None) into
        out[index] / err[index]; allocates out/err (torch.empty) when not
        given.  Rows outside `index` are left as they were.  Every index
        value must lie in [0, N): checked here unless check_index is False,
        since the kernel reads and writes through the index unchecked.
        Returns (out uint8 [N, out_bytes], err bool [N])."""
        dev = blocks.device
        out, err = _rows(blocks, out, err, self.out_bytes)
        n_rows = blocks.shape[0]
        if index is not None:
            if index.dtype != torch.int64 or index.dim() != 1 or index.device != dev or not index.is_contiguous():
                raise ValueError("index must be a contiguous int64 [M] tensor on the blocks' device")
        n = n_rows if index is None else index.shape[0]

        if n == 0:
            return out, err
        if index is not None and check_index:
            count("host_syncs", 2)
            lo, hi = (int(v) for v in torch.aminmax(index))
            if lo < 0 or hi >= n_rows:
                raise ValueError(f"index values must lie in [0, {n_rows}), got [{lo}, {hi}]")
        if dev.type == "cpu":
            self.plain_calls += 1
            PLAIN[self.target](self.mode, blocks, index, out, err)
        elif dev.type == "cuda":
            self._launch(blocks, index, n, out, err)
        else:
            raise ValueError(f"no {self.target} kernel for device {dev}")
        return out, err

    def _launch(self, blocks, index, n, out, err) -> None:
        if n >= 2**31:
            raise ValueError(f"{n} blocks exceed one launch (2^31 - 1)")
        check_alignment(blocks, out)
        launch = getattr(build.load(), build.LAUNCH[self.target])
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            rc = launch(
                self.mode,
                blocks.data_ptr(),
                None if index is None else index.data_ptr(),
                n,
                out.data_ptr(),
                err.data_ptr(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.target} kernel of mode {self.mode}: launch failed, cudaError_t {rc}")
        self.launches += 1
        count("launches")


class TileKernel:
    """UASTC blocks of every mode -> `target`, one launch of
    `uastc_kernel_tiles<Op>` on a card (module docstring)."""

    def __init__(self, target: str):
        self.target = target
        self.out_bytes = OUT_BYTES[target]
        self.launches = 0

    def __call__(self, blocks, out=None, err=None):
        """Transcode every row of blocks into out / err (allocated with
        torch.empty when not given); returns (out uint8 [N, out_bytes],
        err bool [N]).  A CPU tensor takes the plain path: the dispatch's
        partition and each present mode's plain version."""
        out, err = _rows(blocks, out, err, self.out_bytes)
        dev = blocks.device
        if blocks.shape[0] == 0:
            return out, err
        if dev.type == "cpu":
            from . import dispatch  # which imports this module

            ((order, counts),) = dispatch.partition([blocks])
            dispatch.dispatch(blocks, self.target, order, counts, out=out, err=err)
        elif dev.type == "cuda":
            with span("dispatch.launch"):
                self._launch(blocks, out, err)
        else:
            raise ValueError(f"no {self.target} kernel for device {dev}")
        return out, err

    def _launch(self, blocks, out, err) -> None:
        n = blocks.shape[0]
        if n >= 2**31:
            raise ValueError(f"{n} blocks exceed one launch (2^31 - 1)")
        check_alignment(blocks, out)
        rounds = device_counter("tile_warp_rounds", blocks.device)
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            rc = getattr(build.load(), build.LAUNCH_TILES[self.target])(
                blocks.data_ptr(), n, out.data_ptr(), err.data_ptr(), None if rounds is None else rounds.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"{self.target} tile kernel: launch failed, cudaError_t {rc}")
        self.launches += 1
        count("launches")


_KERNELS = {t: tuple(ModeKernel(t, m) for m in range(N_MODES)) for t in TARGETS}
_TILE_KERNELS = {t: TileKernel(t) for t in TILED}


def mode_kernel(target: str, mode: int) -> ModeKernel:
    return _KERNELS[target][mode]


def tile_kernel(target: str) -> TileKernel:
    return _TILE_KERNELS[target]


def resident_warps(target: str, mode: int) -> int:
    """Warps of (target, mode)'s kernel resident on one SM of the current
    card, from the CUDA runtime's occupancy calculator (registers, shared
    memory, CTA size)."""
    warps = ctypes.c_int(0)
    rc = getattr(build.load(), build.WARPS[target])(mode, ctypes.byref(warps))
    if rc != 0:
        raise RuntimeError(f"{target} kernel of mode {mode}: occupancy query failed, cudaError_t {rc}")
    return warps.value


def tile_resident_warps(target: str) -> int:
    """Warps of `target`'s tile kernel resident on one SM of the current
    card (occupancy calculator, with the kernel's shared memory)."""
    warps = ctypes.c_int(0)
    rc = getattr(build.load(), build.TILES_WARPS[target])(ctypes.byref(warps))
    if rc != 0:
        raise RuntimeError(f"{target} tile kernel: occupancy query failed, cudaError_t {rc}")
    return warps.value


def tile_launch_counts() -> dict:
    """{target: launches of its tile kernel}"""
    return {t: k.launches for t, k in _TILE_KERNELS.items()}


def launch_counts() -> dict:
    """{target: [launches of mode 0..18]}"""
    return {t: [k.launches for k in ks] for t, ks in _KERNELS.items()}


def plain_call_counts() -> dict:
    """{target: [plain-version calls of mode 0..18]}"""
    return {t: [k.plain_calls for k in ks] for t, ks in _KERNELS.items()}


def reset_counts() -> None:
    for ks in _KERNELS.values():
        for k in ks:
            k.launches = 0
            k.plain_calls = 0
    for k in _TILE_KERNELS.values():
        k.launches = 0
