"""UASTC -> ETC1 / ETC2 per mode: the plain PyTorch versions of K4 and K5.

Port of `basisu_rs_tpu/ops/etc.py`, mirroring `convert_block_from_uastc` in
the reference's ETC back-end (src/target_formats/etc.rs:32-341): the RGBA
decode of K3 (without alpha for ETC1), then per-subblock average colours,
the hint-driven bias nudges, luminance-projection selectors and, for ETC2,
the EAC alpha block in front of the ETC1 block.  It also holds the ETC
helpers the ETC1S back-end shares (palette, selector wire bits;
etc.rs:343-468).  The packed tables (`ETC1_MOD_PACKED`, `ETC_BIAS_PACKED`,
`EAC_MOD_PACKED`, `EAC_FRACTION_BITS`) are the ones the CUDA header carries
(`tables.etc_packed_tables`).

This is the function the CUDA kernels (`csrc/uastc_etc.cuh`) are held
against: the CPU tests use it, and `chip_smoke.py` compares the kernels with
it on the card.  The kernel wrapper (`ops/kernels.py`) reaches it only for
tensors on the CPU.
"""

from __future__ import annotations

import torch

from ..tables import MODE8_ETC1_FLAGS_OFFSET, MODE8_RGBA_OFFSET, MODES, ModeCfg, device_tables
from .bits import apply_rows, extract, lane_shape
from .rgba import uastc_to_rgba_channels

LUM_FACTORS = (108, 366, 38)

# ---------------------------------------------------------------------------
# shared ETC helpers (etc.rs:343-468)
# ---------------------------------------------------------------------------


def color_5_to_8(c):
    return (c << 3) | (c >> 2)


def color_4_to_8(c):
    return (c << 4) | c


def etc1_palette(base_rgb, inten, tables):
    """4-colour ETC1 palette of a subblock, clamp(base + modifier) per level
    (etc.rs:420-431): [level k][channel c].  Every modifier row is
    [-big, -small, small, big], so one lookup of the packed small | big << 8
    gives all four, and each level needs only a one-sided clamp."""
    w = tables["ETC1_MOD_PACKED"][inten]
    small, big = w & 255, w >> 8
    return [
        [torch.clamp(base_rgb[c] - big, min=0) for c in range(3)],
        [torch.clamp(base_rgb[c] - small, min=0) for c in range(3)],
        [torch.clamp(base_rgb[c] + small, max=255) for c in range(3)],
        [torch.clamp(base_rgb[c] + big, max=255) for c in range(3)],
    ]


def selector_ms_ls(sel):
    """ETC1 wire bits of a 2-bit selector: SELECTOR_ID_TO_ETC1[sel] =
    [3, 2, 0, 1][sel] split into its MSB !(sel>>1) and LSB
    !((sel>>1) ^ (sel&1))."""
    hi = (sel >> 1) & 1
    return hi ^ 1, (hi ^ sel ^ 1) & 1


def selector_wire_bits_from(ms, ls, pixel_id: int):
    """A texel's wire bits in the 32-bit ETC1 selector word at the static
    pixel id (column-major x*4+y; etc.rs:363-393): byte 0 holds the MSBs of
    pixels 8..15, byte 1 those of 0..7, bytes 2 and 3 the LSBs likewise."""
    ms_byte = 1 - pixel_id // 8
    bit = pixel_id % 8
    return (ms.to(torch.int64) << (8 * ms_byte + bit)) | (ls.to(torch.int64) << (8 * (ms_byte + 2) + bit))


def selector_wire_bits(sel, pixel_id: int):
    return selector_wire_bits_from(*selector_ms_ls(sel), pixel_id)


def etc1_selector(lum, th):
    """(ms, ls) wire bits of a texel's selector from its luminance and its
    subblock's three non-decreasing thresholds: the hits c1 >= c2 >= c3 are
    nested, sel = c1 + c2 + c3, so ms = !c2 and ls = c3 | !c1."""
    th01, th12, th23 = th
    return lum < th12, (lum >= th23) | (lum < th01)


# ---------------------------------------------------------------------------
# trans flags (uastc.rs:411-441)
# ---------------------------------------------------------------------------


def decode_trans_flags(cfg: ModeCfg, lanes) -> dict:
    """The ETC hint fields.  Modes 10-12 carry no bc1h1 and no bias field
    (etc1bias is None); only the alpha formats carry etc2tm (0 otherwise)."""
    no_bias = 10 <= cfg.id <= 12
    ofs = cfg.field_offsets["trans_flags"] + (1 if no_bias else 2)  # bc1h0 (and bc1h1)
    out = {
        "etc1f": extract(lanes, ofs, 1),
        "etc1d": extract(lanes, ofs + 1, 1),
        "etc1i0": extract(lanes, ofs + 2, 3),
        "etc1i1": extract(lanes, ofs + 5, 3),
    }
    ofs += 8
    out["etc1bias"] = None if no_bias else extract(lanes, ofs, 5)
    ofs += 0 if no_bias else 5
    if cfg.has_alpha:
        out["etc2tm"] = extract(lanes, ofs, 8)
    else:
        out["etc2tm"] = torch.zeros(lane_shape(lanes), dtype=torch.int64, device=lanes.device)
    return out


# ---------------------------------------------------------------------------
# EAC alpha block (etc.rs:261-341)
# ---------------------------------------------------------------------------

SOLID_ALPHA_LANE0_HI = 0x1D << 8 | 0x92 << 16 | 0x49 << 24  # table 13, multiplier 1
SOLID_ALPHA_LANE1 = 0x24 | 0x92 << 8 | 0x49 << 16 | 0x24 << 24  # every selector 4


def solid_alpha_lanes(value):
    """The solid EAC block of an alpha byte: (lane0, lane1)."""
    return value | SOLID_ALPHA_LANE0_HI, torch.full_like(value, SOLID_ALPHA_LANE1)


def eac_thresholds(center, mult, w01):
    """The 7 thresholds of the EAC selector search for a block's centre,
    multiplier and modifier row (w01: the row's 8 modifiers + 15, a byte
    each, in two words).  The candidates in value order [3,2,1,0,4,5,6,7]
    take pre-halved midpoint thresholds, and the two duplicate-run shapes
    of min_by_key's first-minimal-j rule (mult == 0: all equal; W3 == W4)
    are folded into the thresholds once per block."""
    cbase = center - 15 * mult
    values = [torch.clamp(cbase + ((w01[j >> 2] >> (8 * (j & 3))) & 255) * mult, 0, 255) for j in range(8)]
    W = [values[p] for p in (3, 2, 1, 0, 4, 5, 6, 7)]
    T = [(W[k] + W[k + 1] + (1 if k < 3 else 2)) >> 1 for k in range(7)]
    kill_all = mult == 0
    kill_lo = kill_all | (W[3] == W[4])
    T = [torch.where(kill_lo, 0, T[k]) for k in (0, 1, 2)] + T[3:]
    for k in (4, 5, 6):
        T[k] = torch.where(kill_all, 256, T[k])
    T[3] = torch.where(kill_lo, T[4], T[3])
    return T


def eac_selector(a, T):
    """The EAC selector (0..7) of alpha a: its rank among the thresholds by
    a 3-level search, mapped back to the modifier index."""
    b2 = a >= T[3]
    b1 = a >= torch.where(b2, T[5], T[1])
    t0 = torch.where(b2, torch.where(b1, T[6], T[4]), torch.where(b1, T[2], T[0]))
    u = (b1.to(torch.int64) << 1) | (a >= t0).to(torch.int64)
    return u ^ (3 + b2.to(torch.int64))


def write_etc2_alpha_block(etc2tm, alphas, tables):
    """(lane0, lane1) of the 8-byte EAC alpha block of 16 texel alphas.

    The centre is the reference's f32 lerp, each operation rounded on its
    own (one eager op each); the selector search is the JAX package's
    folded-threshold rank search (eac_thresholds, eac_selector), pinned
    against the reference's min_by_key over every (table, multiplier,
    centre, alpha) in tests/test_torch_etc.py."""
    min_a = alphas[0]
    max_a = alphas[0]
    for a in alphas[1:]:
        min_a = torch.minimum(min_a, a)
        max_a = torch.maximum(max_a, a)

    tbl = etc2tm & 15
    mult = etc2tm >> 4
    # the 8 modifiers of the row, +15, packed 4 a word: values come out as
    # (centre - 15*mult) + byte*mult
    w01 = [tables["EAC_MOD_PACKED"][2 * tbl + h] for h in (0, 1)]
    frac = tables["EAC_FRACTION_BITS"][tbl].to(torch.int32).view(torch.float32)

    # centre = round(lerp(min, max, frac)), half away from zero (>= 0 here)
    lerped = min_a.to(torch.float32) * (1.0 - frac) + max_a.to(torch.float32) * frac
    center = torch.trunc(lerped + 0.5).to(torch.int64)

    T = eac_thresholds(center, mult, w01)

    # The 16 three-bit selectors in one 48-bit payload, big-endian field
    # order, at the transposed pixel id pid = y*4 + x with x = i//4, y = i%4.
    payload = torch.zeros_like(etc2tm)
    for i in range(16):
        pid = (i % 4) * 4 + i // 4
        payload = payload | (eac_selector(alphas[i], T) << (45 - 3 * pid))

    # block byte b (2..7) is payload bits 47-8(b-2) .. 40-8(b-2)
    lane0 = (center & 0xFF) | (etc2tm << 8) | (((payload >> 40) & 0xFF) << 16) | (((payload >> 32) & 0xFF) << 24)
    lane1 = (
        ((payload >> 24) & 0xFF)
        | (((payload >> 16) & 0xFF) << 8)
        | (((payload >> 8) & 0xFF) << 16)
        | ((payload & 0xFF) << 24)
    )
    solid0_min, solid1_min = solid_alpha_lanes(min_a)
    flat = min_a == max_a
    lane0 = torch.where(flat, solid0_min, lane0)
    lane1 = torch.where(flat, solid1_min, lane1)
    no_hint = etc2tm == 0
    lane0 = torch.where(no_hint, 255 | SOLID_ALPHA_LANE0_HI, lane0)
    lane1 = torch.where(no_hint, SOLID_ALPHA_LANE1, lane1)
    return lane0, lane1


# ---------------------------------------------------------------------------
# bias application (etc.rs:113-120, 203-259)
# ---------------------------------------------------------------------------


def subblock_average(ssum, limit):
    """(ssum*limit + 1020) // 2040, the subblock average of a channel sum
    (ssum <= 2040, limit 15 or 31), as an exact mul-shift: the product is at
    most 64260 * 32897 < 2^31."""
    return ((ssum * limit + 1020) * 32897) >> 26


def apply_etc1_bias(color, packed_deltas, limit, subblock: int):
    """color: 3 int64 [N] channel values; packed_deltas: ETC_BIAS_PACKED of
    the block's bias; limit: int64 [N], 15 or 31."""
    out = []
    for c in range(3):
        field = (packed_deltas >> (2 * (3 * subblock + c))) & 3  # delta + 2
        v = color[c]
        plain = v + field - 2
        # v == 0: delta + 1, except delta == -2 -> 3: (field - 1) & 3
        at_zero = (field - 1) & 3
        at_limit = plain - 1
        # for v in 1..limit-1, plain <= limit always and plain < 0 only as
        # -1 (delta -2, v 1), where the reference's v - delta is v + 2
        checked = torch.where(plain < 0, v + 2, plain)
        out.append(torch.where(v == 0, at_zero, torch.where(v == limit, at_limit, checked)))
    return out


# ---------------------------------------------------------------------------
# the ETC1 block
# ---------------------------------------------------------------------------


def mode8_etc1_lanes(lanes):
    """Mode 8: the ETC1 block straight from the hint flags (etc.rs:43-75)."""
    O = MODE8_ETC1_FLAGS_OFFSET
    d = extract(lanes, O, 1)
    inten = extract(lanes, O + 1, 3)
    s = extract(lanes, O + 4, 2)
    rgb = [extract(lanes, O + 6 + 5 * c, 5) for c in range(3)]
    # individual mode writes (c << 4) | c, which the reference's write_u8
    # truncates to 8 bits for a 5-bit c >= 16
    byte = [torch.where(d == 0, ((c << 4) | c) & 0xFF, c << 3) for c in rgb]
    byte3 = (inten << 5) | (inten << 2) | (d << 1)
    lane0 = byte[0] | (byte[1] << 8) | (byte[2] << 16) | (byte3 << 24)
    ms, ls = selector_ms_ls(s)
    return lane0, (0xFFFF * ms) | ((0xFFFF * ls) << 16)


def etc_rgb_lanes(flags, texels, tables):
    """The 8-byte ETC1 block of a non-mode-8 block (etc.rs:78-200).

    The reference transposes the texel grid when !flip; here the subblock
    sums come from shared 2x2-quad sums selected per orientation, and each
    texel u writes its selector at the static pixel id transpose(u) in both
    orientations, comparing against its row pair's thresholds under flip and
    its column pair's otherwise (they differ only on the off-diagonal
    quads)."""
    fm = flags["etc1f"] == 1
    dm = flags["etc1d"] == 1
    limit = torch.where(dm, 31, 15)

    # quad sums [qy][qx][c] over raster texels i = y*4 + x
    quads = [
        [
            [sum(texels[(2 * qy + dy) * 4 + 2 * qx + dx][c] for dy in (0, 1) for dx in (0, 1)) for c in range(3)]
            for qx in range(2)
        ]
        for qy in range(2)
    ]
    avgs = []
    for sb in range(2):
        avg = []
        for c in range(3):
            ssum = torch.where(fm, quads[sb][0][c] + quads[sb][1][c], quads[0][sb][c] + quads[1][sb][c])
            avg.append(subblock_average(ssum, limit))
        avgs.append(avg)

    if flags["etc1bias"] is not None:
        packed = tables["ETC_BIAS_PACKED"][flags["etc1bias"]]
        c0 = apply_etc1_bias(avgs[0], packed, limit, 0)
        c1 = apply_etc1_bias(avgs[1], packed, limit, 1)
    else:
        c0, c1 = avgs

    # colour bytes and palette bases (etc.rs:122-149)
    d = [torch.clamp(c1[c] - c0[c], -4, 3) for c in range(3)]
    color_bytes = [torch.where(dm, (c0[c] << 3) | (d[c] & 7), (c0[c] << 4) | c1[c]) for c in range(3)]
    base0 = [torch.where(dm, color_5_to_8(c0[c]), color_4_to_8(c0[c])) for c in range(3)]
    base1 = [torch.where(dm, color_5_to_8(c0[c] + d[c]), color_4_to_8(c1[c])) for c in range(3)]
    byte3 = (flags["etc1i0"] << 5) | (flags["etc1i1"] << 2) | (flags["etc1d"] << 1) | flags["etc1f"]
    lane0 = color_bytes[0] | (color_bytes[1] << 8) | (color_bytes[2] << 16) | (byte3 << 24)

    # selectors by luminance projection (etc.rs:160-196); palette
    # luminances at half scale (54/183/19), so the reference's
    # (lum_k + lum_k+1) >> 1 of even full-scale values is the plain sum
    th_sb = []
    for pal in (etc1_palette(base0, flags["etc1i0"], tables), etc1_palette(base1, flags["etc1i1"], tables)):
        lums = [pal[k][0] * 54 + pal[k][1] * 183 + pal[k][2] * 19 for k in range(4)]
        th_sb.append((lums[0] + lums[1], lums[1] + lums[2], lums[2] + lums[3]))
    th_quad = {
        (0, 0): th_sb[0],
        (1, 1): th_sb[1],
        (0, 1): tuple(torch.where(fm, th_sb[0][k], th_sb[1][k]) for k in range(3)),
        (1, 0): tuple(torch.where(fm, th_sb[1][k], th_sb[0][k]) for k in range(3)),
    }
    lane1 = torch.zeros_like(lane0)
    for u in range(16):
        q = (u // 8, (u % 4) // 2)
        px = texels[u]
        lum = px[0] * LUM_FACTORS[0] + px[1] * LUM_FACTORS[1] + px[2] * LUM_FACTORS[2]
        lane1 = lane1 | selector_wire_bits_from(*etc1_selector(lum, th_quad[q]), (u % 4) * 4 + u // 4)
    return lane0, lane1


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def uastc_to_etc1_mode(cfg: ModeCfg, lanes):
    """int64 [N,4] UASTC words -> (list of 2 ETC1 output words, err bool[N])."""
    if cfg.id == 8:
        return list(mode8_etc1_lanes(lanes)), torch.zeros(lane_shape(lanes), dtype=torch.bool, device=lanes.device)
    texels, err = uastc_to_rgba_channels(cfg, lanes, need_alpha=False)
    return list(etc_rgb_lanes(decode_trans_flags(cfg, lanes), texels, device_tables(lanes.device))), err


def uastc_to_etc2_mode(cfg: ModeCfg, lanes):
    """int64 [N,4] UASTC words -> (4 ETC2 output words: the EAC alpha block,
    then the ETC1 block; err bool[N])."""
    if cfg.id == 8:
        a0, a1 = solid_alpha_lanes(extract(lanes, MODE8_RGBA_OFFSET + 24, 8))
        r0, r1 = mode8_etc1_lanes(lanes)
        return [a0, a1, r0, r1], torch.zeros(lane_shape(lanes), dtype=torch.bool, device=lanes.device)
    tables = device_tables(lanes.device)
    flags = decode_trans_flags(cfg, lanes)
    texels, err = uastc_to_rgba_channels(cfg, lanes, need_alpha=cfg.has_alpha)
    if cfg.has_alpha:
        a0, a1 = write_etc2_alpha_block(flags["etc2tm"], [px[3] for px in texels], tables)
    else:
        # RGB modes decode alpha 255 and carry no etc2tm: the solid-255 block
        a0, a1 = solid_alpha_lanes(torch.full(lane_shape(lanes), 255, dtype=torch.int64, device=lanes.device))
    r0, r1 = etc_rgb_lanes(flags, texels, tables)
    return [a0, a1, r0, r1], err


def transcode_etc1_rows(mode: int, blocks, index, out, err) -> None:
    """Plain version of one K4 launch: transcode blocks[index] (all UASTC
    mode `mode`) into the uint8 [N,8] rows out[index] and err[index], in
    place.  index=None means every row."""
    apply_rows(lambda lanes: uastc_to_etc1_mode(MODES[mode], lanes), blocks, index, out, err)


def transcode_etc2_rows(mode: int, blocks, index, out, err) -> None:
    """Plain version of one K5 launch: as transcode_etc1_rows, into uint8
    [N,16] rows (EAC alpha block, then ETC1 block)."""
    apply_rows(lambda lanes: uastc_to_etc2_mode(MODES[mode], lanes), blocks, index, out, err)
