"""Constant tables of the transcoder: the port's own copy.

The modules of this package are copies of the pure-numpy tables of the JAX
package (`basisu_rs_tpu/tables/`): `generated_tables`, `modes`, `bise` and
`bc7_tables`, and below, the parts of its `__init__` that the port uses
(the pattern families, their packed per-pattern words, `etc_bias_deltas`,
`np_tables`).  The
port imports nothing of the JAX package; tests/test_torch_tables.py holds
every table and packed array here equal to the JAX package's, and nothing
else keeps the two in step.

The transcoder has no learned weights; its state is these constant tables.
`flat.py` lays every run-time-indexed table out as flat arrays for the plain
PyTorch versions (`device_tables`) and the generated CUDA header
(`gen_header.py` -> `csrc/uastc_tables.cuh`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import generated_tables as G
from .bc7_tables import BC7_MODES, Bc7Mode, bc7_mode_5_optimal_packed, bc7_mode_6_optimal_packed
from .bise import BISE_RANGES, BiseRange, unquant_lut
from .modes import LA, MODE8_ETC1_FLAGS_OFFSET, MODE8_RGBA_OFFSET, MODES, RGB, RGBA, UASTC_BLOCK_SIZE, ModeCfg


def _pack2(rows) -> np.ndarray:
    """Pack rows of 16 two-bit values into one uint32 per row (texel i at bits 2i)."""
    rows = np.asarray(rows, np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    return np.bitwise_or.reduce(rows << shifts, axis=1).astype(np.uint32)


def _pack_nibbles(rows) -> np.ndarray:
    """Pack short rows of values < 16 into one uint32 per row (4 bits each)."""
    rows = np.asarray(rows, np.uint32)
    shifts = (np.arange(rows.shape[1], dtype=np.uint32) * 4)[None, :]
    return np.bitwise_or.reduce(rows << shifts, axis=1).astype(np.uint32)


@dataclass(frozen=True)
class PatternFamily:
    """Per-pattern metadata for one multi-subset mode family, pre-packed so a
    kernel resolves every pattern-dependent value with one lookup per block.

    UASTC side (used when *reading* the block):
      pat_texels / pat_packed: texel -> subset map (ASTC order)
      anchors: [count, nsub] anchor weight indices (read with 1 less bit)
    BC7 side (used when *writing* BC7 blocks):
      bc7_index: BC7 partition index written to the output
      bc7_pat_texels / bc7_pat_packed: texel -> BC7 subset map
      bc7_anchors: [count, 3] BC7 anchor texels (subset 0 anchor is always 0)
      perm: [count, 3] endpoint permutation, BC7 subset j <- UASTC subset perm[j]
    ASTC side:
      astc_index10: 10-bit ASTC partition seed
    """

    name: str
    count: int
    nsub: int
    pat_texels: np.ndarray
    pat_packed: np.ndarray
    anchors: np.ndarray
    anchors_packed: np.ndarray
    astc_index10: np.ndarray
    bc7_index: np.ndarray
    bc7_pat_texels: np.ndarray
    bc7_pat_packed: np.ndarray
    bc7_anchors: np.ndarray
    bc7_anchors_packed: np.ndarray
    perm: np.ndarray
    perm_packed: np.ndarray


def _family(name, nsub, pats, anchors, astc10, bc7_meta, bc7_pats, bc7_anchor_tab, perms):
    pats = np.asarray(pats, np.uint8)
    anchors = np.asarray(anchors, np.uint8)
    count = len(pats)
    bc7_index = np.asarray([m[0] for m in bc7_meta], np.uint8)
    bc7_pats = np.asarray(bc7_pats, np.uint8)
    bc7_anchors = np.asarray([bc7_anchor_tab[i] for i in bc7_index], np.uint8)
    if bc7_anchors.shape[1] == 2:  # pad to 3 columns (unused subset)
        bc7_anchors = np.concatenate([bc7_anchors, np.zeros((count, 1), np.uint8)], axis=1)
    perm = np.asarray(perms, np.uint8)
    if perm.shape[1] == 2:
        perm = np.concatenate([perm, np.zeros((count, 1), np.uint8)], axis=1)
    return PatternFamily(
        name=name,
        count=count,
        nsub=nsub,
        pat_texels=pats,
        pat_packed=_pack2(pats),
        anchors=anchors,
        anchors_packed=_pack_nibbles(anchors),
        astc_index10=np.asarray(astc10, np.uint16),
        bc7_index=bc7_index,
        bc7_pat_texels=bc7_pats,
        bc7_pat_packed=_pack2(bc7_pats),
        bc7_anchors=bc7_anchors,
        bc7_anchors_packed=_pack_nibbles(bc7_anchors),
        perm=perm,
        perm_packed=_pack_nibbles(perm),
    )


@lru_cache(maxsize=None)
def _families() -> dict:
    perm2 = [([1, 0] if inv else [0, 1]) for _, inv in G.PATTERNS_2_BC7_INDEX_INV]
    perm3 = [G.PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS[p] for _, p in G.PATTERNS_3_BC7_INDEX_PERM]
    perm23 = [G.PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS[p] for _, p in G.PATTERNS_2_3_BC7_INDEX_PERM]
    return {
        "2": _family(
            "2", 2, G.PATTERNS_2, G.PATTERNS_2_ANCHORS, G.PATTERNS_2_ASTC_INDEX_10,
            G.PATTERNS_2_BC7_INDEX_INV, G.PATTERNS_2_BC7, G.PATTERNS_2_BC7_ANCHORS, perm2,
        ),
        "3": _family(
            "3", 3, G.PATTERNS_3, G.PATTERNS_3_ANCHORS, G.PATTERNS_3_ASTC_INDEX_10,
            G.PATTERNS_3_BC7_INDEX_PERM, G.PATTERNS_3_BC7, G.PATTERNS_3_BC7_ANCHORS, perm3,
        ),
        # Mode 7: 2 UASTC subsets drawn from the 2/3 common-partition table,
        # mapped onto 3-subset BC7 mode 2 (reference: bc7.rs:128-137).
        "23": _family(
            "23", 2, G.PATTERNS_2_3, G.PATTERNS_2_3_ANCHORS, G.PATTERNS_2_3_ASTC_INDEX_10,
            G.PATTERNS_2_3_BC7_INDEX_PERM, G.PATTERNS_2_3_BC7, G.PATTERNS_3_BC7_ANCHORS, perm23,
        ),
        # Mode 1: single UASTC subset mapped onto 2-subset BC7 mode 3 with
        # partition 0 and both BC7 subsets fed the same endpoints
        # (reference: bc7.rs:119-127).
        "m1": _family(
            "m1", 1, [G.PATTERNS_2_BC7[0]], [[0]], [0],
            [G.PATTERNS_2_BC7_INDEX_INV[0]], [G.PATTERNS_2_BC7[0]],
            G.PATTERNS_2_BC7_ANCHORS, [[0, 0]],
        ),
    }


def get_family(mode: ModeCfg) -> PatternFamily | None:
    """The pattern family a mode draws its partitions from, or None for
    single-subset modes (reference: uastc.rs:352-385)."""
    if mode.id == 1:
        return _families()["m1"]
    if mode.id == 7:
        return _families()["23"]
    if mode.subset_count == 1:
        return None
    return _families()["2" if mode.subset_count == 2 else "3"]


def _pack2_cols(tab: np.ndarray) -> np.ndarray:
    """int [count, 16] values <= 3 -> uint32 [count], 2 bits per texel."""
    assert (tab <= 3).all() and (tab >= 0).all()
    return _pack2(tab)


@lru_cache(maxsize=None)
def fam_anchors_before(fam_name: str) -> np.ndarray:
    """int64 [count, 16]: UASTC-side anchors_before_i per pattern and texel
    (anchor weights are stored with one less bit, uastc.rs:727-740)."""
    fam = _families()[fam_name]
    i = np.arange(16)
    return (fam.anchors[:, :, None].astype(np.int64) < i[None, None, :]).sum(1)


@lru_cache(maxsize=None)
def fam_anchors_before_packed(fam_name: str) -> np.ndarray:
    """uint32 [count]: fam_anchors_before packed 2 bits per texel."""
    return _pack2_cols(fam_anchors_before(fam_name))


@lru_cache(maxsize=None)
def fam_bc7_anchors_before(fam_name: str) -> np.ndarray:
    """int64 [count, 16]: BC7-side anchors_before_i per pattern and texel
    (anchor texels are written with one less bit; subset-0 anchor is 0)."""
    fam = _families()[fam_name]
    i = np.arange(16)
    nsub = {"2": 2, "3": 3, "23": 3, "m1": 2}[fam_name]
    anch = fam.bc7_anchors[:, :nsub].astype(np.int64)  # includes a0 = 0
    return (anch[:, :, None] < i[None, None, :]).sum(1)


@lru_cache(maxsize=None)
def fam_bc7_inv_relpos_packed(fam_name: str, weight_bits: int) -> np.ndarray:
    """uint32 [count]: per-pattern (rel_bitpos | valid<<7) bytes, one per BC7
    subset k >= 1, locating the single stored weight bit that drives the
    reference's anchor-MSB endpoint swap + weight inversion (bc7.rs:171-195).

    rel_bitpos (relative to the mode's weight-section start) is the raw MSB
    of BC7 anchor texel a's stored field: weight_bits*a - anchors_before(a)
    + weight_bits - 1.  Every weight remap of a multi-subset mode preserves
    the MSB, so the raw stored bit is the BC7 MSB.  valid = 0 when the BC7
    anchor coincides with a UASTC anchor: its field is stored with one less
    bit, so its full-width MSB is statically zero."""
    fam = _families()[fam_name]
    ab = fam_anchors_before(fam_name)
    nsub = {"2": 2, "3": 3, "23": 3, "m1": 2}[fam_name]
    out = np.zeros(fam.count, np.uint32)
    for p in range(fam.count):
        uanch = {int(x) for x in fam.anchors[p]}
        for k in range(1, nsub):
            a = int(fam.bc7_anchors[p][k])
            rel = weight_bits * a - int(ab[p, a]) + weight_bits - 1
            assert 0 <= rel < 64
            valid = 0 if a in uanch else 1
            out[p] |= np.uint32(rel | (valid << 7)) << (8 * (k - 1))
    return out


@lru_cache(maxsize=None)
def fam_bc7_weight_preshift_packed(fam_name: str) -> np.ndarray:
    """uint32 [count]: per-texel BC7 weight-emission pre-shift
    (max-anchors-before-over-patterns minus anchors-before), packed 2 bits
    per texel: the shift that places a weight inside its static emission
    window directly."""
    ab = fam_bc7_anchors_before(fam_name)
    return _pack2_cols(ab.max(axis=0, keepdims=True) - ab)


@lru_cache(maxsize=None)
def etc_bias_deltas() -> np.ndarray:
    """[32 bias, 2 subblock, 3 channel] int8 ETC1 bias nudges
    (reference: src/target_formats/etc.rs:203-234)."""
    d = np.zeros((32, 2, 3), np.int8)
    s_divs = (1, 3, 9)
    for bias in range(32):
        for sb in range(2):
            for c in range(3):
                special = {
                    2: 0 if sb else (-1 if c == 0 else 0),
                    5: 0 if sb else (-1 if c == 1 else 0),
                    6: 0 if sb else (-1 if c == 2 else 0),
                    7: 0 if sb else (1 if c == 0 else 0),
                    11: 0 if sb else (1 if c == 1 else 0),
                    15: 0 if sb else (1 if c == 2 else 0),
                    18: (-1 if c == 0 else 0) if sb else 0,
                    19: (-1 if c == 1 else 0) if sb else 0,
                    20: (-1 if c == 2 else 0) if sb else 0,
                    21: (1 if c == 0 else 0) if sb else 0,
                    24: (1 if c == 1 else 0) if sb else 0,
                    8: (1 if c == 2 else 0) if sb else 0,
                    10: -2,
                    27: 0 if sb else -1,
                    28: -1 if sb else 1,
                    29: 1 if sb else 0,
                    30: -1 if sb else 0,
                    31: 0 if sb else 1,
                }
                d[bias, sb, c] = special.get(bias, ((bias // s_divs[c]) % 3) - 1)
    return d


@lru_cache(maxsize=None)
def np_tables() -> dict:
    """The numpy constant arrays of the UASTC paths, keyed by name."""
    etc2_mod = np.asarray(G.ETC2_ALPHA_MODIFIERS, np.int32)
    mod_min = etc2_mod[:, 3].astype(np.float32)
    mod_range = (etc2_mod[:, 7] - etc2_mod[:, 3]).astype(np.float32)
    return {
        "MODE_LUT": np.asarray(G.MODE_LUT, np.uint8),
        "ASTC_QUINT_ENCODE": np.asarray(G.ASTC_QUINT_ENCODE_LUT, np.uint8),
        "ASTC_TRIT_ENCODE": np.asarray(G.ASTC_TRIT_ENCODE_LUT, np.uint8),
        "UASTC_TO_ASTC_BLOCK_MODE_13": np.asarray(G.UASTC_TO_ASTC_BLOCK_MODE_13, np.uint16),
        "UASTC_TO_BC7_MODES": np.asarray(G.UASTC_TO_BC7_MODES, np.uint8),
        "ETC1_MODIFIERS": np.asarray(G.ETC1_MODIFIERS, np.int32),
        "ETC2_ALPHA_MODIFIERS": etc2_mod,
        # fl(-mod_min / range) per EAC table row (etc.rs:305), IEEE f32
        "ETC2_ALPHA_FRACTION": (-mod_min / mod_range).astype(np.float32),
        "SELECTOR_ID_TO_ETC1": np.array([0b11, 0b10, 0b00, 0b01], np.uint8),
        "ETC_BIAS_DELTAS": etc_bias_deltas(),
    }


# The flat kernel layout builds on everything above.
from .flat import (  # noqa: E402
    FAMILIES,
    INVALID_MODE,
    Layout,
    bc7_mode_of,
    device_tables,
    etc_packed_tables,
    family_consts,
    family_name,
    inv_relpos_bounds,
    kernel_tables,
)

__all__ = [
    "BC7_MODES",
    "BISE_RANGES",
    "Bc7Mode",
    "BiseRange",
    "FAMILIES",
    "INVALID_MODE",
    "LA",
    "Layout",
    "MODE8_ETC1_FLAGS_OFFSET",
    "MODE8_RGBA_OFFSET",
    "MODES",
    "ModeCfg",
    "PatternFamily",
    "RGB",
    "RGBA",
    "UASTC_BLOCK_SIZE",
    "bc7_mode_5_optimal_packed",
    "bc7_mode_6_optimal_packed",
    "bc7_mode_of",
    "device_tables",
    "etc_bias_deltas",
    "etc_packed_tables",
    "fam_anchors_before",
    "fam_anchors_before_packed",
    "fam_bc7_anchors_before",
    "fam_bc7_inv_relpos_packed",
    "fam_bc7_weight_preshift_packed",
    "family_consts",
    "family_name",
    "get_family",
    "inv_relpos_bounds",
    "kernel_tables",
    "np_tables",
    "unquant_lut",
]
