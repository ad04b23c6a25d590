"""P: the fl_div255 hardware probe, plain version and wrapper.

Counterpart of the two probe kernels of the JAX package's tests,
`tests/test_pbits.py:68` (pl.pallas_call at :73, interpret mode) and
`tests/test_tpu_hardware.py:76` (:80, on the chip), which evaluate
`bits.fl_div255` inside a kernel to check that the hardware rounds it as
IEEE `x/255`.  The CUDA kernel (`csrc/fl_div255_probe.cu`) evaluates the
port's device `ub::fl_div255` (`csrc/uastc_decode.cuh`), which K1's shared
p-bit search depends on, compiled with the library's flags (`--fmad=false`).

The plain version is numpy's `np.float32(x) / np.float32(255)`: one IEEE
f32 division, computed with torch.  `fl_div255(x)` is the wrapper: a tensor
on the CPU goes to the plain version, a CUDA tensor to the kernel, or the
call raises.  It counts its launches and plain-version calls.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build


def plain(x):
    """IEEE-f32 x / 255 of int32 x (numpy's np.float32(x) / np.float32(255)).
    The divisor is a 0-dim tensor: with a Python scalar divisor, PyTorch's
    CUDA division multiplies by the scalar's reciprocal instead."""
    return x.to(torch.float32) / torch.tensor(255.0, dtype=torch.float32, device=x.device)


def two_roundings_np(x) -> np.ndarray:
    """The device formula fl(y0 + fl(y0 * K)), y0 = fl(x * 257 * 2^-16), on
    the host in f32 with every operation rounded on its own: what the card
    must compute for any int32 x.  It equals IEEE x/255 for x in 0..255."""
    y0 = np.asarray(x).astype(np.float32) * np.float32(257.0 / 65536.0)
    return (y0 + (y0 * np.float32(65537.0 / 2**32)).astype(np.float32)).astype(np.float32)


class Probe:
    def __init__(self):
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, x, out=None):
        """x: contiguous int32 [N]; returns out, float32 [N]."""
        dev = x.device
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous int32 [N] tensor, got {x.dtype} {tuple(x.shape)}")
        n = x.shape[0]
        if out is None:
            out = torch.empty(n, dtype=torch.float32, device=dev)
        if out.dtype != torch.float32 or out.shape != (n,) or out.device != dev or not out.is_contiguous():
            raise ValueError("out must be a contiguous float32 [N] tensor on x's device")
        if n == 0:
            return out
        if dev.type == "cpu":
            self.plain_calls += 1
            out.copy_(plain(x))
        elif dev.type == "cuda":
            if n >= 2**31:
                raise ValueError(f"{n} values exceed one launch (2^31 - 1)")
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = build.load().fl_div255_launch(x.data_ptr(), n, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"fl_div255 probe: launch failed, cudaError_t {rc}")
            self.launches += 1
        else:
            raise ValueError(f"no fl_div255 probe kernel for device {dev}")
        return out


fl_div255 = Probe()
