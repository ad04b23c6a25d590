"""PyTorch port: the plain version of K3 (UASTC -> 16 packed RGBA texels,
basisu_rs_tpu_torch/ops/rgba.py) against the JAX package, per UASTC mode,
bit-exact (tolerance 0) on the output bytes and the err flags: the golden
pairs, seeded random blocks of every mode against the XLA path, and a few
modes against the Pallas kernel in interpret mode, and a few blocks of every
mode against the scalar oracle, tests/oracle_uastc.py (inputs:
tests/torch_cases.py)."""

import numpy as np
import pytest
import torch

import oracle_uastc as ou
from basisu_rs_tpu_torch.api import transcode_uastc_blocks
from torch_cases import assert_same, jax_pallas_interpret, jax_xla, mode_blocks, plain

TARGET = "rgba"
PALLAS_MODES = (3, 7, 8, 17)


@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_xla(golden, mode):
    blocks = mode_blocks(golden, mode, 300)
    assert_same(f"mode {mode}", blocks, plain(TARGET, mode, blocks), jax_xla(TARGET, mode, blocks))


@pytest.mark.parametrize("mode", PALLAS_MODES)
def test_plain_matches_pallas_interpret(golden, mode):
    blocks = mode_blocks(golden, mode, 64, seed=1)
    assert_same(f"mode {mode}", blocks, plain(TARGET, mode, blocks), jax_pallas_interpret(TARGET, mode, blocks))


def test_golden_pairs_bit_exact(golden):
    out, err = transcode_uastc_blocks(golden["rgba_in"], TARGET, device="cpu")
    assert out.dtype == torch.uint32 and tuple(out.shape) == golden["rgba_out"].shape
    assert not err.any()
    assert_same("all", golden["rgba_in"], (out.numpy().view(np.uint8), err.numpy()),
                (golden["rgba_out"].view(np.uint8), np.zeros(len(out), bool)))


@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_oracle(golden, mode):
    # valid blocks only: the oracle raises where the kernels set err
    blocks = mode_blocks(golden, mode, 24, seed=2)
    out, err = plain(TARGET, mode, blocks)
    for b, o, e in zip(blocks, out, err):
        if not e:
            texels = ou.decode_block_to_rgba(b.tobytes())
            assert o.tobytes() == bytes(c for texel in texels for c in texel), f"mode {mode}: {b.tolist()}"
