"""PyTorch port: the plain version of K1 (basisu_rs_tpu_torch/ops/bc7.py)
against the JAX package, per UASTC mode, bit-exact (tolerance 0) on the
output bytes and the err flags.

Inputs are made with numpy from a fixed seed: random blocks whose first
byte is one of the mode's 7-bit codes (random pattern fields include
out-of-range ones), plus that mode's golden blocks."""

import numpy as np
import pytest
import torch

from basisu_rs_tpu.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_tpu.ops.dispatch import _mode_kernel
from basisu_rs_tpu.ops.pallas_kernels import pallas_mode_kernel
from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.api import transcode_uastc_blocks
from basisu_rs_tpu_torch.ops import bc7

PALLAS_MODES = (2, 3, 6, 7, 8, 9, 15, 18)


def mode_blocks(golden, mode, n_random, seed=0):
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(seed * 19 + mode)
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (n_random, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, n_random)
    gold = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


def plain(mode, blocks):
    t = torch.from_numpy(blocks)
    out = torch.zeros_like(t)
    err = torch.zeros(len(blocks), dtype=torch.bool)
    bc7.transcode_rows(mode, t, None, out, err)
    return out.numpy(), err.numpy()


def assert_same(mode, blocks, got, expect):
    (out, err), (e_out, e_err) = got, expect
    bad = np.nonzero(np.any(out != e_out, axis=1) | (err != e_err))[0]
    assert bad.size == 0, (
        f"mode {mode}: {bad.size}/{len(blocks)} blocks differ; first {blocks[bad[0]].tolist()}\n"
        f"got {out[bad[0]].tolist()} err {err[bad[0]]}\nexp {e_out[bad[0]].tolist()} err {e_err[bad[0]]}"
    )


@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_xla(golden, mode):
    blocks = mode_blocks(golden, mode, 480)
    o, e = _mode_kernel("bc7", mode, "xla")(lanes_from_bytes_np(blocks, 4))
    expect = bytes_from_lanes_np(np.asarray(o)), np.asarray(e)
    assert_same(mode, blocks, plain(mode, blocks), expect)


@pytest.mark.parametrize("mode", PALLAS_MODES)
def test_plain_matches_pallas_interpret(golden, mode):
    blocks = mode_blocks(golden, mode, 96, seed=1)
    o, e = pallas_mode_kernel("bc7", mode, rows=8, interpret=True)(lanes_from_bytes_np(blocks, 4))
    expect = bytes_from_lanes_np(np.asarray(o)), np.asarray(e)
    assert_same(mode, blocks, plain(mode, blocks), expect)


def test_golden_pairs_bit_exact(golden):
    out, err = transcode_uastc_blocks(golden["bc7_in"], "bc7")
    assert not err.any()
    assert_same("all", golden["bc7_in"], (out.numpy(), err.numpy()),
                (golden["bc7_out"], np.zeros(len(out), bool)))
