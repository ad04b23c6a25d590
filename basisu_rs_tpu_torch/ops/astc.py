"""UASTC -> ASTC 4x4 block repack per mode: the plain PyTorch version of K2.

Port of `basisu_rs_tpu/ops/astc.py` (`uastc_to_astc_mode`, `_mode8_to_astc`),
mirroring `convert_block_from_uastc` (reference:
src/target_formats/astc.rs:8-181): blue-contraction avoidance (endpoint swap
+ weight inversion), the block-mode / partition / CEM header, the quantized
endpoints re-encoded in ASTC integer sequence encoding through the trit and
quint pack LUTs, and the weights written bit-reversed from the end of the
block.

This is the function the CUDA kernel (`csrc/uastc_astc.cuh`) is held
against: the CPU tests use it, and `chip_smoke.py` compares the kernel with
it on the card.  The kernel wrapper (`ops/kernels.py`) reaches it only for
tensors on the CPU.
"""

from __future__ import annotations

import torch

from ..tables import BISE_RANGES, LA, MODES, RGB, RGBA, ModeCfg, device_tables, get_family, np_tables
from .bits import LaneWriter, apply_rows, bitrev, lane_shape, mask
from .uastc_decode import (
    decode_compsel,
    decode_endpoints,
    decode_mode8_rgba,
    decode_pattern,
    decode_weights,
    fam_row,
    subsets_for_texels,
)

CEM = {RGB: 8, RGBA: 12, LA: 4}  # ASTC colour endpoint mode per UASTC format
# (bit offset, width) of each member's share of a packed quint / trit group
QUINT_SLICES = ((0, 3), (3, 2), (5, 2))
TRIT_SLICES = ((0, 2), (2, 2), (4, 1), (5, 2), (7, 1))


def _mode8_to_astc(lanes):
    """Void-extent block (astc.rs:17-43)."""
    rgba = decode_mode8_rgba(lanes)
    shape = lane_shape(lanes)
    w = LaneWriter(shape, 4, lanes.device)
    w.put_const(0b1101_1111_1100, 0, 12)
    w.put_const(0x000F_FFFF, 12, 20)
    w.put_const(0xFFFF_FFFF, 32, 32)
    for c in range(4):
        w.put((rgba[c] << 8) | rgba[c], 64 + 16 * c, 16)
    return w.lanes, torch.zeros(shape, dtype=torch.bool, device=lanes.device)


def uastc_to_astc_mode(cfg: ModeCfg, lanes):
    """int64 [N,4] UASTC words -> (list of 4 ASTC output words, err bool[N])."""
    if cfg.id == 8:
        return _mode8_to_astc(lanes)

    tables = device_tables(lanes.device)
    shape = lane_shape(lanes)
    rng = BISE_RANGES[cfg.endpoint_range_index]
    e_count = cfg.endpoint_count
    wb = cfg.weight_bits

    compsel = decode_compsel(cfg, lanes)
    pat, err = decode_pattern(cfg, lanes)
    tq, qbits, unq = decode_endpoints(cfg, lanes, tables)
    tq, qbits = list(tq), list(qbits)
    weights, _ = decode_weights(cfg, lanes, pat, tables)

    # ---- blue-contraction avoidance (astc.rs:55-78) ----
    # Per subset: if the unquantized lo endpoints of the first 3 channels sum
    # above the hi ones, swap every quantized pair and invert its weights.
    per_subset = e_count // cfg.subset_count
    invert = [torch.zeros(shape, dtype=torch.bool, device=lanes.device)] * cfg.subset_count
    if cfg.format != LA:
        for s in range(cfg.subset_count):
            b = s * per_subset
            inv = unq[b] + unq[b + 2] + unq[b + 4] > unq[b + 1] + unq[b + 3] + unq[b + 5]
            invert[s] = inv
            for k in range(b, b + per_subset, 2):
                for q in (tq, qbits):
                    lo, hi = q[k], q[k + 1]
                    q[k], q[k + 1] = torch.where(inv, hi, lo), torch.where(inv, lo, hi)

    writer = LaneWriter(shape, 4, lanes.device)

    # ---- header (astc.rs:80-96) ----
    writer.put_const(int(np_tables()["UASTC_TO_ASTC_BLOCK_MODE_13"][cfg.id]), 0, 13)
    ofs = 13
    fam = get_family(cfg)
    if fam is not None and cfg.id != 1:
        writer.put(tables["FAM_ASTC_INDEX10"][fam_row(fam.name, pat)], ofs, 10)
        ofs += 10 + 2  # +2 zero bits: all endpoints share one CEM
    writer.put_const(CEM[cfg.format], ofs, 4)
    ofs += 4

    # ---- endpoints in ASTC integer sequence encoding (astc.rs:98-141) ----
    if rng.quints or rng.trits:
        base, per, slices, enc = (
            (5, 3, QUINT_SLICES, tables["ASTC_QUINT_ENCODE"])
            if rng.quints
            else (3, 5, TRIT_SLICES, tables["ASTC_TRIT_ENCODE"])
        )
        zero = torch.zeros(shape, dtype=torch.int64, device=lanes.device)
        for chunk in range(0, e_count, per):
            members = min(per, e_count - chunk)
            lut_id = zero
            for k in reversed(range(members)):
                lut_id = lut_id * base + tq[chunk + k]
            packed = enc[lut_id]
            for k, (sh, width) in enumerate(slices):
                writer.put(qbits[chunk + k] if k < members else zero, ofs, rng.bits)
                ofs += rng.bits
                writer.put(packed >> sh, ofs, width)
                ofs += width
    else:
        for k in range(e_count):
            writer.put(qbits[k], ofs, rng.bits)
            ofs += rng.bits

    # ---- weights, bit-reversed from the end (astc.rs:143-178) ----
    # The k-th decoded weight lands at bits [128-(k+1)*wb, 128-k*wb), its wb
    # bits reversed, XOR-inverted when its texel's subset was swapped.
    inv_masks = [inv.to(torch.int64) * mask(wb) for inv in invert]
    if cfg.subset_count == 1:
        inv_m = inv_masks * 16
    else:
        subsets = subsets_for_texels(cfg, pat, tables)
        inv_m = []
        for i in range(16):
            v = inv_masks[0]
            for s in range(1, cfg.subset_count):
                v = torch.where(subsets[i] == s, inv_masks[s], v)
            inv_m.append(v)

    n_weights = 16 * cfg.plane_count
    for k in range(n_weights):
        wv = weights[k] ^ inv_m[k // cfg.plane_count]
        writer.put(bitrev(wv, wb), 128 - (k + 1) * wb, wb)
    if cfg.plane_count != 1:
        # CCS, not bit-reversed (astc.rs:174-177)
        writer.put(compsel, 128 - n_weights * wb - 2, 2)

    return writer.lanes, err


def transcode_rows(mode: int, blocks, index, out, err) -> None:
    """Plain version of one K2 launch: transcode blocks[index] (all UASTC
    mode `mode`) into out[index] / err[index], in place.  index=None means
    every row."""
    apply_rows(lambda lanes: uastc_to_astc_mode(MODES[mode], lanes), blocks, index, out, err)
