"""PyTorch port: the public API (basisu_rs_tpu_torch/api.py) against the
JAX package's api.py, bit-exact, with the same block-level errors."""

import numpy as np
import pytest
import torch

import basisu_rs_tpu.api as japi
import basisu_rs_tpu_torch as tapi
from basisu_rs_tpu.tables import MODES
from basisu_rs_tpu_torch.ops import kernels


def _mixed_blocks(golden):
    """Golden blocks, random blocks with every 7-bit code (invalid mode 19
    and out-of-range patterns included), and zero blocks, shuffled."""
    rng = np.random.default_rng(5)
    r = rng.integers(0, 256, (1024, 16), dtype=np.uint8)
    blocks = np.concatenate([golden["bc7_in"], r, np.zeros((3, 16), np.uint8)])
    return np.ascontiguousarray(blocks[rng.permutation(len(blocks))])


def _bad_pattern_block():
    block = np.zeros(16, np.uint8)
    block[0] = 0x1D  # a mode-2 code; pattern field set to 31 (>= 30)
    ofs = MODES[2].field_offsets["pattern"]
    for b in range(5):
        block[(ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    return block


def test_batch_matches_jax(golden):
    blocks = _mixed_blocks(golden)
    e_out, e_err = japi.transcode_uastc_blocks(blocks, "bc7")
    out, err = tapi.transcode_uastc_blocks(blocks, "bc7")
    assert out.dtype == torch.uint8 and out.shape == (len(blocks), 16)
    assert err.dtype == torch.bool and err.shape == (len(blocks),)
    assert err.numpy().any() and not err.numpy().all()
    np.testing.assert_array_equal(err.numpy(), e_err)
    np.testing.assert_array_equal(out.numpy(), e_out)


def test_batch_takes_torch_and_device(golden):
    t = torch.from_numpy(golden["bc7_in"][:40].copy())
    out, err = tapi.transcode_uastc_blocks(t, "bc7", device="cpu")
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), golden["bc7_out"][:40])
    assert not err.any()


def test_empty_batch():
    out, err = tapi.transcode_uastc_blocks(np.zeros((0, 16), np.uint8), "bc7")
    e_out, e_err = japi.transcode_uastc_blocks(np.zeros((0, 16), np.uint8), "bc7")
    assert tuple(out.shape) == e_out.shape == (0, 16)
    assert tuple(err.shape) == e_err.shape == (0,)


@pytest.mark.parametrize("index", [0, 100, 303, 607])
def test_single_block_matches_jax(golden, index):
    block = golden["bc7_in"][index]
    got = tapi.transcode_uastc_block_to_bc7(block)
    assert got == japi.transcode_uastc_block_to_bc7(block) == golden["bc7_out"][index].tobytes()
    assert tapi.transcode_uastc_block_to_bc7(bytes(block)) == got


@pytest.mark.parametrize("case", ["invalid_mode", "invalid_pattern", "short"])
def test_single_block_errors_match_jax(case):
    if case == "invalid_mode":
        block = np.zeros(16, np.uint8)
        block[0] = 69
    elif case == "invalid_pattern":
        block = _bad_pattern_block()
    else:
        block = np.zeros(15, np.uint8)
    with pytest.raises(japi.BasisError) as jexc:
        japi.transcode_uastc_block_to_bc7(block)
    with pytest.raises(tapi.BasisError) as texc:
        tapi.transcode_uastc_block_to_bc7(block)
    assert str(texc.value) == str(jexc.value)


def test_launch_counter_stays_zero_on_cpu(golden):
    kernels.reset_counts()
    tapi.transcode_uastc_blocks(golden["bc7_in"], "bc7")
    assert kernels.launch_counts() == [0] * 19
    assert kernels.plain_call_counts() == [1] * 19


@pytest.mark.parametrize("target", ["rgba", "astc", "etc1", "etc2", "png"])
def test_other_targets_not_ported(target):
    with pytest.raises(NotImplementedError, match="ROADMAP|unknown"):
        tapi.transcode_uastc_blocks(np.zeros((1, 16), np.uint8), target)
