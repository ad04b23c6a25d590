"""PyTorch port: the plain version of K1 (basisu_rs_tpu_torch/ops/bc7.py)
against the JAX package, per UASTC mode, bit-exact (tolerance 0) on the
output bytes and the err flags (inputs: tests/torch_cases.py), and a few
blocks of every mode against the scalar oracle (tests/oracle_uastc.py)."""

import numpy as np
import pytest

import oracle_uastc as ou
from basisu_rs_tpu_torch.api import transcode_uastc_blocks
from torch_cases import assert_same, jax_pallas_interpret, jax_xla, mode_blocks, plain

PALLAS_MODES = (2, 3, 6, 7, 8, 9, 15, 18)


@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_xla(golden, mode):
    blocks = mode_blocks(golden, mode, 480)
    assert_same(f"mode {mode}", blocks, plain("bc7", mode, blocks), jax_xla("bc7", mode, blocks))


@pytest.mark.parametrize("mode", PALLAS_MODES)
def test_plain_matches_pallas_interpret(golden, mode):
    blocks = mode_blocks(golden, mode, 96, seed=1)
    assert_same(f"mode {mode}", blocks, plain("bc7", mode, blocks), jax_pallas_interpret("bc7", mode, blocks))


def test_golden_pairs_bit_exact(golden):
    out, err = transcode_uastc_blocks(golden["bc7_in"], "bc7", device="cpu")
    assert not err.any()
    assert_same("all", golden["bc7_in"], (out.numpy(), err.numpy()),
                (golden["bc7_out"], np.zeros(len(out), bool)))


@pytest.mark.parametrize("mode", range(19))
def test_plain_matches_oracle(golden, mode):
    # valid blocks only: the oracle raises where the kernels set err
    blocks = mode_blocks(golden, mode, 24, seed=2)
    out, err = plain("bc7", mode, blocks)
    for b, o, e in zip(blocks, out, err):
        if not e:
            assert o.tobytes() == ou.convert_block_to_bc7(b.tobytes()), f"mode {mode}: {b.tolist()}"
