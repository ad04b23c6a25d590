"""PyTorch port: the plain versions of K4 (UASTC -> ETC1) and K5 (UASTC ->
ETC2 RGBA), basisu_rs_tpu_torch/ops/etc.py, against the JAX package and the
scalar oracle, per UASTC mode, bit-exact (tolerance 0) on the output bytes
and the err flags: seeded random blocks of every mode against the XLA path,
four modes (a 3-subset mode, mode 8, a no-bias mode, an LA alpha mode)
against the Pallas kernel in interpret mode, the golden pairs through the
batch API, and a few blocks of every mode against tests/oracle_uastc.py.
Then the exhaustive pins of the plain forms the kernels share: the EAC
selector search, the ETC1 selector boolean forms, the subblock-average
mul-shift and the bias rule (their C++ forms are pinned in
tests/test_torch_csrc_host.py)."""

import numpy as np
import pytest
import torch

import oracle_uastc as ou
from basisu_rs_tpu_torch.api import transcode_uastc_blocks
from basisu_rs_tpu_torch.ops import etc
from basisu_rs_tpu_torch.tables import MODE8_ETC1_FLAGS_OFFSET, device_tables
from torch_cases import (
    assert_same,
    bias_reference,
    eac_reference_selectors,
    etc1_selector_cases,
    jax_pallas_interpret,
    jax_xla,
    mode_blocks,
    plain,
)

TARGETS = ("etc1", "etc2")
PALLAS_MODES = (3, 8, 11, 15)
ORACLE = {"etc1": ou.convert_block_to_etc1, "etc2": ou.convert_block_to_etc2}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_xla(golden, target, mode):
    blocks = mode_blocks(golden, mode, 300)
    assert_same(f"{target} mode {mode}", blocks, plain(target, mode, blocks), jax_xla(target, mode, blocks))


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", PALLAS_MODES)
def test_plain_matches_pallas_interpret(golden, target, mode):
    blocks = mode_blocks(golden, mode, 64, seed=1)
    assert_same(f"{target} mode {mode}", blocks, plain(target, mode, blocks),
                jax_pallas_interpret(target, mode, blocks))


@pytest.mark.parametrize("target", TARGETS)
def test_golden_pairs_bit_exact(golden, target):
    blocks = golden[f"{target}_in"]
    out, err = transcode_uastc_blocks(blocks, target, device="cpu")
    assert out.dtype == torch.uint8 and tuple(out.shape) == golden[f"{target}_out"].shape
    assert not err.any()
    assert_same("all", blocks, (out.numpy(), err.numpy()), (golden[f"{target}_out"], np.zeros(len(out), bool)))


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_oracle(golden, target, mode):
    # valid blocks only: the oracle raises where the kernels set err
    blocks = mode_blocks(golden, mode, 24, seed=2)
    out, err = plain(target, mode, blocks)
    for b, o, e in zip(blocks, out, err):
        if not e:
            assert o.tobytes() == ORACLE[target](b.tobytes()), f"{target} mode {mode}: {b.tolist()}"


def test_eac_selector_exhaustive():
    # the folded rank search against min_by_key over every table,
    # multiplier, centre and alpha
    tables = device_tables("cpu")
    center = torch.arange(256)[:, None]
    alpha = torch.arange(256)[None, :]
    for tbl in range(16):
        w01 = [tables["EAC_MOD_PACKED"][2 * tbl + h] for h in (0, 1)]
        for mult in range(16):
            T = etc.eac_thresholds(center, torch.tensor(mult), w01)
            got = etc.eac_selector(alpha, T).numpy()
            np.testing.assert_array_equal(got, eac_reference_selectors(tbl, mult), err_msg=f"table {tbl} mult {mult}")


def test_etc1_selector_forms():
    lum, th, expected = etc1_selector_cases()
    ms, ls = etc.etc1_selector(torch.from_numpy(lum), tuple(torch.from_numpy(th[:, k]) for k in range(3)))
    np.testing.assert_array_equal((ms.to(torch.int64) | (ls.to(torch.int64) << 1)).numpy(), expected)


@pytest.mark.parametrize("limit", [15, 31])
def test_subblock_average_exhaustive(limit):
    ssum = torch.arange(2041)
    np.testing.assert_array_equal(etc.subblock_average(ssum, torch.tensor(limit)).numpy(),
                                  (np.arange(2041) * limit + 1020) // 2040)


@pytest.mark.parametrize("limit", [15, 31])
def test_bias_rule_exhaustive(limit):
    packed = device_tables("cpu")["ETC_BIAS_PACKED"]
    v = torch.arange(limit + 1)
    for bias in range(32):
        for sb in range(2):
            got = etc.apply_etc1_bias([v] * 3, packed[bias], torch.tensor(limit), sb)
            for c in range(3):
                np.testing.assert_array_equal(got[c].numpy(), bias_reference(bias, limit, sb, c),
                                              err_msg=f"bias {bias} subblock {sb} channel {c}")


def test_mode8_individual_bytes_wrap(golden):
    # mode 8 in individual mode (etc1d = 0) with 5-bit colours >= 16: the
    # reference's u8 write truncates (c << 4) | c
    block = np.zeros((1, 16), np.uint8)
    block[0, 0] = next(b for b in range(128) if ou._MODE_LUT[b] == 8)
    lanes = int.from_bytes(block[0].tobytes(), "little")
    # etc1d 0, etc1i 5, etc1s 2, then 5-bit r, g, b of 31, 16 and 23
    for ofs, val in ((1, 5), (4, 2), (6, 31), (11, 16), (16, 23)):
        lanes |= val << (MODE8_ETC1_FLAGS_OFFSET + ofs)
    block[0] = np.frombuffer(lanes.to_bytes(16, "little"), np.uint8)
    for target in TARGETS:
        out, err = plain(target, 8, block)
        assert not err[0]
        assert out[0].tobytes() == ORACLE[target](block[0].tobytes())
        assert out[0, -8:-5].tolist() == [0xFF, 0x10, 0x77]  # 0x1FF, 0x110, 0x177 cut to a byte
