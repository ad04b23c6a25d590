"""The flat kernel layout of the constant tables.

`kernel_tables()` lays out every table the UASTC -> BC7 / ASTC / RGBA /
ETC1 / ETC2 paths index at run time as flat arrays (one array per kind,
families and ranges concatenated, with static base offsets).  The same layout feeds both the
plain PyTorch versions (`device_tables`) and the generated CUDA header
(`gen_header.py` -> `csrc/uastc_tables.cuh`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import (
    BC7_MODES,
    BISE_RANGES,
    MODES,
    _families,
    bc7_mode_5_optimal_packed,
    bc7_mode_6_optimal_packed,
    fam_anchors_before,
    fam_anchors_before_packed,
    fam_bc7_anchors_before,
    fam_bc7_inv_relpos_packed,
    fam_bc7_weight_preshift_packed,
    get_family,
    np_tables,
    unquant_lut,
)

INVALID_MODE = 19

# Pattern families in table order (`Family<F>` in the CUDA header).
FAMILIES = ("2", "3", "23", "m1")

# Per-pattern family tables, concatenated over FAMILIES.
_FAM_KINDS = (
    "ANCHORS_PACKED",
    "ANCHORS_BEFORE_PACKED",
    "BC7_INDEX",
    "BC7_PAT_PACKED",
    "BC7_ANCHORS_PACKED",
    "PERM_PACKED",
    "BC7_WEIGHT_PRESHIFT_PACKED",
    "PAT_PACKED",
    "ASTC_INDEX10",
)
_FAM_DTYPE = {"BC7_INDEX": np.uint8, "ASTC_INDEX10": np.uint16}


def _fam_arrays(name: str) -> dict:
    fam = _families()[name]
    return {
        "ANCHORS_PACKED": fam.anchors_packed,
        "ANCHORS_BEFORE_PACKED": fam_anchors_before_packed(name),
        "BC7_INDEX": fam.bc7_index,
        "BC7_PAT_PACKED": fam.bc7_pat_packed,
        "BC7_ANCHORS_PACKED": fam.bc7_anchors_packed,  # BC7 anchor texel of subset j: nibble j
        "PERM_PACKED": fam.perm_packed,
        "BC7_WEIGHT_PRESHIFT_PACKED": fam_bc7_weight_preshift_packed(name),
        "PAT_PACKED": fam.pat_packed,  # texel -> UASTC subset, 2 bits a texel
        "ASTC_INDEX10": fam.astc_index10,
    }


def family_name(cfg) -> str | None:
    fam = get_family(cfg)
    return None if fam is None else fam.name


def _pack_cols(tab: np.ndarray) -> int:
    """[count, 16] values <= 3 -> (column min packed, column max packed),
    2 bits per texel."""
    lo = hi = 0
    for t in range(16):
        lo |= int(tab[:, t].min()) << (2 * t)
        hi |= int(tab[:, t].max()) << (2 * t)
    return lo, hi


@dataclass(frozen=True)
class Layout:
    """Static base offsets into the flat kernel tables."""

    fam_base: dict  # family name -> row offset into every FAM_* table
    unquant_base: dict  # BISE range index -> offset into UNQUANT_LUT
    inv_relpos_base: dict  # (family name, weight bits) -> offset


@lru_cache(maxsize=None)
def kernel_tables():
    """(arrays, layout): every run-time-indexed table of the BC7, ASTC,
    RGBA, ETC1 and ETC2 paths as flat numpy arrays (dtype = the CUDA
    header's element type)."""
    t = np_tables()
    arrays: dict = {k: t[k].astype(np.uint8) for k in ("MODE_LUT", "ASTC_QUINT_ENCODE", "ASTC_TRIT_ENCODE")}

    unquant, unquant_base, n = [], {}, 0
    for r, rng in enumerate(BISE_RANGES):
        if rng.trits or rng.quints:
            lut = unquant_lut(r)
            unquant_base[r] = n
            unquant.append(lut)
            n += len(lut)
    arrays["UNQUANT_LUT"] = np.concatenate(unquant).astype(np.uint8)

    fam_base, n = {}, 0
    per_kind = {k: [] for k in _FAM_KINDS}
    for name in FAMILIES:
        fam_base[name] = n
        n += _families()[name].count
        for k, a in _fam_arrays(name).items():
            per_kind[k].append(a)
    for k in _FAM_KINDS:
        arrays["FAM_" + k] = np.concatenate(per_kind[k]).astype(_FAM_DTYPE.get(k, np.uint32))

    relpos, inv_base, n = [], {}, 0
    for cfg in MODES:
        name = family_name(cfg)
        bc7 = BC7_MODES[int(np_tables()["UASTC_TO_BC7_MODES"][cfg.id])]
        if cfg.id == 8 or bc7.subset_count == 1 or (name, cfg.weight_bits) in inv_base:
            continue
        inv_base[(name, cfg.weight_bits)] = n
        a = fam_bc7_inv_relpos_packed(name, cfg.weight_bits)
        relpos.append(a)
        n += len(a)
    arrays["FAM_BC7_INV_RELPOS_PACKED"] = np.concatenate(relpos).astype(np.uint32)

    arrays["BC7_MODE_5_OPTIMAL_PACKED"] = bc7_mode_5_optimal_packed().astype(np.uint16)
    arrays["BC7_MODE_6_OPTIMAL_PACKED"] = bc7_mode_6_optimal_packed().astype(np.uint16)
    arrays.update(etc_packed_tables())
    return arrays, Layout(fam_base, unquant_base, inv_base)


def etc_packed_tables() -> dict:
    """The ETC tables of K4/K5 in the packed forms of the JAX package's
    `ops/etc.py`, each one lookup a block:
      ETC1_MOD_PACKED[inten]      small | big << 8 of the row [-big, -small, small, big]
      ETC_BIAS_PACKED[bias]       delta + 2 in 2 bits at 2*(3*subblock + channel)
      EAC_MOD_PACKED[2*tbl + h]   modifiers 4h..4h+3 of EAC table tbl, + 15, a byte each
      EAC_FRACTION_BITS[tbl]      the f32 bit pattern of ETC2_ALPHA_FRACTION[tbl]"""
    t = np_tables()
    mods = t["ETC1_MODIFIERS"]
    assert (mods[:, 0] == -mods[:, 3]).all() and (mods[:, 1] == -mods[:, 2]).all()
    deltas = t["ETC_BIAS_DELTAS"].astype(np.uint32) + 2
    bias = np.zeros(32, np.uint32)
    for sb in range(2):
        for c in range(3):
            bias |= (deltas[:, sb, c] & 3) << (2 * (3 * sb + c))
    eac = (t["ETC2_ALPHA_MODIFIERS"] + 15).astype(np.uint32)  # 0..29
    assert ((eac >= 0) & (eac < 256)).all()
    eac_words = eac.reshape(16, 2, 4) << (8 * np.arange(4, dtype=np.uint32))
    return {
        "ETC1_MOD_PACKED": (mods[:, 2] | (mods[:, 3] << 8)).astype(np.uint32),
        "ETC_BIAS_PACKED": bias,
        "EAC_MOD_PACKED": np.bitwise_or.reduce(eac_words, axis=2).reshape(32).astype(np.uint32),
        "EAC_FRACTION_BITS": t["ETC2_ALPHA_FRACTION"].view(np.uint32).copy(),
    }


@lru_cache(maxsize=None)
def family_consts(name: str) -> dict:
    """Static per-family constants (the `Family<F>` traits of the header)."""
    fam = _families()[name]
    ab_lo, ab_hi = _pack_cols(fam_anchors_before(name))
    b_lo, b_hi = _pack_cols(fam_bc7_anchors_before(name))
    return {
        "count": fam.count,
        "n_anchors": int(fam.anchors.shape[1]),
        "base": kernel_tables()[1].fam_base[name],
        "ab_min_packed": ab_lo,
        "ab_max_packed": ab_hi,
        "bc7_ab_min_packed": b_lo,
        "bc7_ab_max_packed": b_hi,
    }


def inv_relpos_bounds(name: str, weight_bits: int) -> list:
    """Static (min, max) of the relative anchor-MSB bit position for BC7
    subsets 1 and 2 over the family's patterns."""
    a = fam_bc7_inv_relpos_packed(name, weight_bits)
    out = []
    for s in (1, 2):
        rel = (a >> (8 * (s - 1))) & 63
        out.append((int(rel.min()), int(rel.max())))
    return out


def bc7_mode_of(cfg) -> int:
    return int(np_tables()["UASTC_TO_BC7_MODES"][cfg.id])


_DEVICE_TABLES: dict = {}


def device_tables(device) -> dict:
    """kernel_tables() arrays as torch tensors on `device`, cached per
    device.  MODE_LUT stays uint8 (the dispatch sorts its uint8 result);
    every other table is int64, the plain version's word type."""
    device = torch.device(device)
    if device not in _DEVICE_TABLES:
        arrays, _ = kernel_tables()
        _DEVICE_TABLES[device] = {
            k: torch.as_tensor(a if k == "MODE_LUT" else a.astype(np.int64), device=device)
            for k, a in arrays.items()
        }
    return _DEVICE_TABLES[device]
