"""Mode-specialized UASTC block field decoding, in PyTorch.

Port of `basisu_rs_tpu/ops/uastc_decode.py`: `decode_fields`, the weight
unquantization, the factored ASTC lerp, the texel -> subset map and
`decode_mode8_rgba`.  Each function takes a static `ModeCfg` plus an int64
`[N, 4]` word tensor (see bits.py) and returns per-block int64 field
tensors.  Every bit offset is a Python int
fixed by the mode; the only dynamic offsets are the weight positions of
multi-subset modes, which depend on the block's pattern index.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tables import BISE_RANGES, LA, MODE8_RGBA_OFFSET, ModeCfg, fam_anchors_before, get_family, kernel_tables
from .bits import extract, lane_shape, mask


@dataclass
class Fields:
    """Decoded per-block fields for one mode (int64 [N] tensors)."""

    err: object  # bool[N] - invalid pattern index
    compsel: object  # 0..3
    pat: object  # clamped to a valid pattern index
    endpoints: list  # E x dequantized 0..255
    quant_tq: list  # E x raw trit/quint digit
    quant_bits: list  # E x raw bit part
    weights: list  # (16*planes) x raw quantized weights (decode order)
    anchors: list  # nsub x anchor texel indices


def _zeros(lanes):
    return torch.zeros(lane_shape(lanes), dtype=torch.int64, device=lanes.device)


def _bise_layout(cfg: ModeCfg):
    """Static (base, offset, width, members) read plan of the trit/quint
    digit groups, plus the offset where the raw bits start."""
    rng = BISE_RANGES[cfg.endpoint_range_index]
    e = cfg.endpoint_count
    ofs = cfg.field_offsets["endpoints"]
    groups = []
    if rng.quints:
        full, rem = e // 3, e % 3
        for _ in range(full):
            groups.append((5, ofs, 7, 3))
            ofs += 7
        if rem:
            w = {1: 3, 2: 5}[rem]
            groups.append((5, ofs, w, rem))
            ofs += w
    if rng.trits:
        full, rem = e // 5, e % 5
        for _ in range(full):
            groups.append((3, ofs, 8, 5))
            ofs += 8
        if rem:
            w = {1: 2, 2: 4, 3: 5, 4: 7}[rem]
            groups.append((3, ofs, w, rem))
            ofs += w
    return groups, ofs, rng


# floor(g/3) = (g*171)>>9 and floor(g/5) = (g*205)>>10 for every group
# value g <= 255 (pinned exhaustively in tests/test_tables.py)
DIGIT_DIV_MULSHIFT = {3: (171, 9), 5: (205, 10)}


def decode_endpoints(cfg: ModeCfg, lanes, tables):
    """Returns (quant_tq, quant_bits, unquant) lists of int64[N] (length E)."""
    groups, bits_ofs, rng = _bise_layout(cfg)
    e = cfg.endpoint_count
    tq = []
    for base, ofs, width, members in groups:
        g = extract(lanes, ofs, width)
        m, sh = DIGIT_DIV_MULSHIFT[base]
        for k in range(members):
            if k == members - 1:
                # the last quotient is < 2*base: mod is a conditional subtract
                tq.append(g - base * (g >= base).to(torch.int64))
            else:
                q = (g * m) >> sh
                tq.append(g - q * base)
                g = q
    if not tq:
        tq = [_zeros(lanes)] * e
    qbits = []
    for i in range(e):
        if rng.bits:
            qbits.append(extract(lanes, bits_ofs + i * rng.bits, rng.bits))
        else:
            qbits.append(_zeros(lanes))
    unquant = [unquant_endpoint(tq[i], qbits[i], cfg.endpoint_range_index, tables) for i in range(e)]
    return tq, qbits, unquant


def unquant_endpoint(trit_quint, bits, range_index: int, tables):
    """ASTC endpoint dequantization (reference: uastc.rs:585-614).

    Pure-bit ranges replicate bits; trit/quint ranges read the unquant LUT
    at (trit_quint << bits) | bits (a plain gather: on this hardware there
    is no 128-lane chunk limit, so every range uses its LUT)."""
    rng = BISE_RANGES[range_index]
    if rng.trits == 0 and rng.quints == 0:
        if rng.bits == 8:
            return bits
        sh = 8 - rng.bits
        val = bits << sh
        sh -= rng.bits
        while sh > -rng.bits:
            val = val | (bits << sh if sh >= 0 else bits >> -sh)
            sh -= rng.bits
        return val
    base = kernel_tables()[1].unquant_base[range_index]
    return tables["UNQUANT_LUT"][base + ((trit_quint << rng.bits) | bits)]


def decode_compsel(cfg: ModeCfg, lanes):
    if cfg.plane_count == 2 and cfg.format == LA:
        return torch.full(lane_shape(lanes), 3, dtype=torch.int64, device=lanes.device)
    if cfg.compsel_bits:
        return extract(lanes, cfg.field_offsets["compsel"], 2)
    return _zeros(lanes)


def decode_pattern(cfg: ModeCfg, lanes):
    """Returns (pat_clamped, err); err marks an out-of-range pattern index
    (uastc.rs:361-365)."""
    if cfg.pattern_bits == 0:
        z = _zeros(lanes)
        return z, torch.zeros(lane_shape(lanes), dtype=torch.bool, device=lanes.device)
    pat = extract(lanes, cfg.field_offsets["pattern"], cfg.pattern_bits)
    err = pat >= cfg.pattern_count
    return torch.clamp(pat, max=cfg.pattern_count - 1), err


def fam_row(fam_name: str, pat):
    return kernel_tables()[1].fam_base[fam_name] + pat


def decode_anchors(cfg: ModeCfg, pat, tables):
    """Anchor texel indices, one per subset (texel 0 for single-subset
    modes, including mode 1 whose read anchor list is [0])."""
    fam = get_family(cfg)
    if fam is None or cfg.subset_count == 1 and cfg.id != 7:
        return [torch.zeros_like(pat)]
    packed = tables["FAM_ANCHORS_PACKED"][fam_row(fam.name, pat)]
    return [(packed >> (4 * k)) & 15 for k in range(fam.nsub)]


def decode_weights(cfg: ModeCfg, lanes, pat, tables):
    """Raw quantized weights in decode order (k = plane_count*i + plane).
    Anchor texels are stored with one less bit (uastc.rs:727-740)."""
    wb = cfg.weight_bits
    planes = cfg.plane_count
    base = cfg.field_offsets["weights"]
    anchors = decode_anchors(cfg, pat, tables)
    multi = cfg.subset_count > 1 or cfg.id == 7

    weights = []
    if not multi:
        ofs = base
        for i in range(16):
            bits_i = wb - 1 if i == 0 else wb
            for _ in range(planes):
                weights.append(extract(lanes, ofs, bits_i))
                ofs += bits_i
        return weights, anchors

    # Multi-subset modes are all single-plane.  Texel i's wb bits lie in the
    # static window [base + wb*i - maxab_i, base + wb*i + wb), maxab_i being
    # the largest anchors-before count of column i over the family: a static
    # extract and a small variable right shift by (maxab_i - ab_i).
    assert planes == 1
    fam = get_family(cfg)
    ab_tab = fam_anchors_before(fam.name)  # [count, 16] numpy
    ab_packed = tables["FAM_ANCHORS_BEFORE_PACKED"][fam_row(fam.name, pat)]
    abs_: list = []
    for i in range(16):
        lo, hi = int(ab_tab[:, i].min()), int(ab_tab[:, i].max())
        abs_.append(lo if lo == hi else (ab_packed >> (2 * i)) & 3)
    abs_.append(fam.anchors.shape[1])
    for i in range(16):
        ab, maxab = abs_[i], int(ab_tab[:, i].max())
        ia = abs_[i + 1] - ab  # is-anchor: consecutive counts differ by 1
        wmask = mask(wb) >> ia
        if isinstance(ab, int):
            raw = extract(lanes, base + wb * i - ab, wb)
        else:
            win = extract(lanes, base + wb * i - maxab, wb + maxab)
            raw = win >> (maxab - ab)
        weights.append(raw & wmask)
    return weights, anchors


def unquant_weight(w, weight_bits: int):
    """Quantized weight -> 0..64 scale, closed forms of the reference LUTs
    (uastc.rs:697-719)."""
    if weight_bits == 1:
        return w * 64
    if weight_bits == 2:
        return 21 * w + (w >= 2).to(torch.int64)
    if weight_bits == 3:
        return 9 * w + (w >= 4).to(torch.int64)
    if weight_bits == 4:
        # correction (w>=4) + 2*(w>=8) + (w>=12) == q + (q>>1) for q = w>>2
        q = w >> 2
        return 4 * w + q + (q >> 1)
    if weight_bits == 5:
        return 2 * w + 2 * (w >= 16).to(torch.int64)
    raise ValueError(weight_bits)


def interp_hoist(l, h):
    """Per-block halves of the factored ASTC lerp: (L0, D) with
    L0 = 257*64*l + 32 and D = 257*(h-l), as shift-adds."""
    d = h - l
    return (l << 14) + (l << 6) + 32, (d << 8) + d


def interp_eval(L0, D, w):
    """(L0 + D*w) >> 14, the per-texel half of the factored ASTC lerp
    ((l*257)*(64-w) + (h*257)*w + 32) >> 14 (uastc.rs:218-235).  The sum
    lies in [32, 4194272]: int32-safe and non-negative, so the shift is a
    floor."""
    return (L0 + D * w) >> 14


def subsets_for_texels(cfg: ModeCfg, pat, tables):
    """texel -> subset assignment, list of 16 int64[N] (uastc.rs:368-376).
    Mode 1 has a family (for BC7) but a single UASTC subset: all zero."""
    fam = get_family(cfg)
    if fam is None or cfg.id == 1:
        return [torch.zeros_like(pat)] * 16
    packed = tables["FAM_PAT_PACKED"][fam_row(fam.name, pat)]
    return [(packed >> (2 * i)) & 3 for i in range(16)]


def assemble_endpoint_pairs(cfg: ModeCfg, endpoints):
    """[subset][lo/hi][channel rgba] nested list (uastc.rs:176-216).
    RGB modes share one constant-255 tensor for alpha."""
    pairs = []
    full = torch.full_like(endpoints[0], 255)
    if cfg.format == 0:  # RGB
        for s in range(cfg.subset_count):
            b = endpoints[s * 6 : (s + 1) * 6]
            pairs.append([[b[0], b[2], b[4], full], [b[1], b[3], b[5], full]])
    elif cfg.format == 1:  # RGBA
        for s in range(cfg.subset_count):
            b = endpoints[s * 8 : (s + 1) * 8]
            pairs.append([[b[0], b[2], b[4], b[6]], [b[1], b[3], b[5], b[7]]])
    else:  # LA
        for s in range(cfg.subset_count):
            b = endpoints[s * 4 : (s + 1) * 4]
            pairs.append([[b[0], b[0], b[0], b[2]], [b[1], b[1], b[1], b[3]]])
    return pairs


def decode_fields(cfg: ModeCfg, lanes, tables) -> Fields:
    """Full non-mode-8 field decode."""
    assert cfg.id != 8
    compsel = decode_compsel(cfg, lanes)
    pat, err = decode_pattern(cfg, lanes)
    tq, qbits, unq = decode_endpoints(cfg, lanes, tables)
    weights, anchors = decode_weights(cfg, lanes, pat, tables)
    return Fields(err, compsel, pat, unq, tq, qbits, weights, anchors)


def decode_mode8_rgba(lanes):
    """Void-extent solid color, channels (r, g, b, a) (uastc.rs:387-394)."""
    return [extract(lanes, MODE8_RGBA_OFFSET + 8 * c, 8) for c in range(4)]
