"""PyTorch port: T1 (the K1 stage-ablation kernels) and P (the fl_div255
probe), plain versions against the JAX package on the CPU.

The JAX stage closures are restated here from tools/ablate_bc7.py:126-190
(that file is not imported: it sets a JAX compilation cache and imports the
TPU backend of Pallas).  The permute_invert closure calls `bc7._dyn_select`,
which the JAX package no longer has: `_dyn_select` below restates the
helper's last definition (basisu_rs_tpu/ops/bc7.py before commit 1e9a97e),
and the closure calls it instead.  Inputs: each mode's golden blocks plus
seeded random blocks of the mode (tests/torch_cases.py).  Every comparison
is exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basisu_rs_tpu.ops import bc7 as jbc7
from basisu_rs_tpu.ops import bits as jbits
from basisu_rs_tpu.ops import uastc_decode as jud
from basisu_rs_tpu.ops.bits import lanes_from_bytes_np
from basisu_rs_tpu.tables import MODES, get_family
from basisu_rs_tpu_torch.ops import bc7_stages, build, fl_div255_probe
from torch_cases import mode_blocks
from test_pbits import TRUE_DIV


def _xor_all(arrs):
    out = None
    for a in arrs:
        a = a.astype(jnp.uint32)
        out = a if out is None else out ^ a
    return out


def _dyn_select(arrays, idx):
    """arrays: list of [N] tensors; idx: int32[N] -> arrays[idx] elementwise."""
    out = arrays[0]
    for k in range(1, len(arrays)):
        out = jnp.where(idx == k, arrays[k], out)
    return out


def jax_stage(stage, cfg):
    """The tool's closure of `stage` for mode cfg (ablate_bc7.py:126-190)."""

    def full(lanes):
        words, err = jbc7.uastc_to_bc7_mode(cfg, lanes)
        return _xor_all(words) ^ err.astype(jnp.uint32)

    def decode_endpoints(lanes):
        _, _, unq = jud.decode_endpoints(cfg, lanes)
        return _xor_all(unq)

    def decode_weights(lanes):
        pat, _ = jud.decode_pattern(cfg, lanes)
        w, anchors = jud.decode_weights(cfg, lanes, pat)
        return _xor_all(w) ^ _xor_all(anchors)

    def decode_fields(lanes):
        f = jud.decode_fields(cfg, lanes)
        return _xor_all(f.endpoints) ^ _xor_all(f.weights) ^ f.compsel ^ f.pat

    def pbit(lanes):
        e_lo = [jbits.extract(lanes, 8 * c, 8).astype(jnp.int32) for c in range(4)]
        e_hi = [jbits.extract(lanes, 32 + 8 * c, 8).astype(jnp.int32) for c in range(4)]
        acc = None
        for _ in range(cfg.subset_count):
            lo, hi, p0, p1 = jbc7.determine_unique_pbits(4, 5, e_lo, e_hi)
            v = _xor_all(lo) ^ _xor_all(hi) ^ p0 ^ p1
            acc = v if acc is None else acc ^ v
        return acc

    def permute_invert(lanes):
        f = jud.decode_fields(cfg, lanes)
        pairs = jud.assemble_endpoint_pairs(cfg, f.endpoints)
        w = [[jbc7.remap_weight_to_bc7(f.weights[i], cfg.weight_bits, 4) for i in range(16)]]
        fam = get_family(cfg)
        nsub7 = cfg.subset_count
        bc7_pat = jbits.lut_lookup(fam.bc7_index, f.pat)
        pat_packed = jbits.lut_lookup(fam.bc7_pat_packed, f.pat)
        subs7 = [(pat_packed >> (2 * i)) & 3 for i in range(16)]
        anch_packed = jbits.lut_lookup(fam.bc7_anchors_packed, f.pat)
        anchors = [jnp.zeros_like(f.pat)] + [(anch_packed >> (4 * k)) & 15 for k in range(1, nsub7)]
        perm_packed = jbits.lut_lookup(fam.perm_packed, f.pat)
        acc = bc7_pat
        inv = [((_dyn_select(w[0], anchors[s]) >> 3) & 1).astype(bool) for s in range(nsub7)]
        for j in range(nsub7):
            pj = (perm_packed >> (4 * j)) & 15
            for c in range(4):
                lo = _dyn_select([pairs[s][0][c] for s in range(cfg.subset_count)], pj)
                hi = _dyn_select([pairs[s][1][c] for s in range(cfg.subset_count)], pj)
                acc = acc ^ jnp.where(inv[j], hi, lo)
        for i in range(16):
            inv_i = _dyn_select([inv[s].astype(jnp.int32) for s in range(nsub7)], subs7[i])
            acc = acc ^ jnp.where(inv_i == 1, (~w[0][i]) & 15, w[0][i])
        return acc

    return {"full": full, "decode_endpoints": decode_endpoints, "decode_weights": decode_weights,
            "decode_fields": decode_fields, "pbit": pbit, "permute_invert": permute_invert}[stage]


def jax_checksums(stage, mode, blocks):
    lanes = lanes_from_bytes_np(blocks, 4)
    planes = tuple(jnp.asarray(lanes[:, w]) for w in range(4))
    return np.asarray(jax.jit(jax_stage(stage, MODES[mode]))(planes)).astype(np.uint32)


@pytest.mark.parametrize("stage", bc7_stages.STAGES)
@pytest.mark.parametrize("mode", range(19))
def test_stage_checksums_match_jax(golden, mode, stage):
    if mode not in bc7_stages.STAGE_MODES[stage]:
        # the pairs left out are exactly those whose JAX closure does not trace:
        # permute_invert reads a pattern family (AttributeError without one),
        # mode 8's fields (AssertionError) and a 4-bit weight remap (ValueError
        # for mode 13's 1-bit weights)
        expected = (AttributeError, AssertionError, ValueError) if stage == "permute_invert" else AssertionError
        with pytest.raises(expected):
            jax.eval_shape(jax_stage(stage, MODES[mode]), (jax.ShapeDtypeStruct((8,), jnp.uint32),) * 4)
        with pytest.raises(ValueError, match="does not trace"):
            bc7_stages.stage_kernel(mode, stage)
        return
    blocks = mode_blocks(golden, mode, 512, seed=3)
    got = bc7_stages.stage_kernel(mode, stage)(torch.from_numpy(blocks)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, jax_checksums(stage, mode, blocks), err_msg=f"mode {mode} {stage}")


def test_pbit_even_subset_checksum_is_zero(golden):
    # the tool XORs one search result twice for 2-subset modes
    blocks = torch.from_numpy(mode_blocks(golden, 2, 64))
    assert not bc7_stages.stage_kernel(2, "pbit")(blocks).any()
    assert bc7_stages.stage_kernel(3, "pbit")(torch.from_numpy(mode_blocks(golden, 3, 64))).any()


def test_permute_invert_does_not_trace():
    # the tool's sixth closure calls a helper the JAX package removed, which
    # is why jax_stage restates it
    assert not hasattr(jbc7, "_dyn_select")


def test_stage_wrapper_counts_and_checks(golden):
    k = bc7_stages.stage_kernel(5, "full")
    before = k.plain_calls
    blocks = torch.from_numpy(mode_blocks(golden, 5, 16))
    out = torch.zeros(len(blocks), dtype=torch.int32)
    assert k(blocks, out) is out
    assert k.plain_calls == before + 1 and k.launches == 0
    with pytest.raises(ValueError, match="uint8"):
        k(blocks.to(torch.int32))
    with pytest.raises(ValueError, match="int32"):
        k(blocks, torch.zeros(len(blocks), dtype=torch.int64))
    assert len(bc7_stages.launch_counts()) == 100
    assert build.parse_ptxas(
        "ptxas info    : Compiling entry function '_ZN2ub16bc7_stage_kernelILi16ELi4EEEvPK5uint4iPj' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 20 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN2ub22fl_div255_probe_kernelEPKiPfi' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 8 registers, used 0 barriers\n"
    ) == {
        ("bc7_stage/pbit", 16): {"registers": 20, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("probe", "fl_div255"): {"registers": 8, "stack": 0, "spill_stores": 0, "spill_loads": 0},
    }


def test_probe_plain_matches_true_div():
    x = torch.arange(256, dtype=torch.int32)
    got = fl_div255_probe.fl_div255(x).numpy()
    np.testing.assert_array_equal(got.view(np.int32), TRUE_DIV.view(np.int32))


def test_probe_two_roundings_equal_true_div_below_256_only():
    x = np.arange(1 << 16)
    dev = fl_div255_probe.two_roundings_np(x)
    ieee = x.astype(np.float32) / np.float32(255)
    np.testing.assert_array_equal(dev[:256].view(np.int32), TRUE_DIV.view(np.int32))
    # the identity is not claimed past 255; the probe records how far it holds
    assert (dev.view(np.int32) != ieee.view(np.int32)).sum() > 0
