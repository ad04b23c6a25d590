"""Shared inputs and checks of the PyTorch port's per-kernel tests
(tests/test_torch_{bc7,astc,rgba}.py).

Inputs are made with numpy from a fixed seed: random blocks whose first
byte is one of the mode's 7-bit codes (random pattern fields include
out-of-range ones), plus that mode's golden blocks."""

import numpy as np
import torch

from basisu_rs_tpu.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_tpu.ops.dispatch import _mode_kernel
from basisu_rs_tpu.ops.pallas_kernels import pallas_mode_kernel
from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.ops import kernels


def mode_blocks(golden, mode, n_random, seed=0):
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(seed * 19 + mode)
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (n_random, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, n_random)
    gold = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


def plain(target, mode, blocks):
    """The port's plain version of one launch over every row, on the CPU:
    (out uint8 [N, OUT_BYTES], err bool [N]) as numpy."""
    t = torch.from_numpy(blocks)
    out = torch.zeros(len(blocks), kernels.OUT_BYTES[target], dtype=torch.uint8)
    err = torch.zeros(len(blocks), dtype=torch.bool)
    kernels.PLAIN[target](mode, t, None, out, err)
    return out.numpy(), err.numpy()


def jax_xla(target, mode, blocks):
    o, e = _mode_kernel(target, mode, "xla")(lanes_from_bytes_np(blocks, 4))
    return bytes_from_lanes_np(np.asarray(o)), np.asarray(e)


def jax_pallas_interpret(target, mode, blocks):
    o, e = pallas_mode_kernel(target, mode, rows=8, interpret=True)(lanes_from_bytes_np(blocks, 4))
    return bytes_from_lanes_np(np.asarray(o)), np.asarray(e)


def assert_same(label, blocks, got, expect):
    """Bit-exact (tolerance 0) on the output bytes and the err flags."""
    (out, err), (e_out, e_err) = got, expect
    bad = np.nonzero(np.any(out != e_out, axis=1) | (err != e_err))[0]
    assert bad.size == 0, (
        f"{label}: {bad.size}/{len(blocks)} blocks differ; first {blocks[bad[0]].tolist()}\n"
        f"got {out[bad[0]].tolist()} err {err[bad[0]]}\nexp {e_out[bad[0]].tolist()} err {e_err[bad[0]]}"
    )
