"""UASTC -> BC7 block repack per mode: the plain PyTorch version of K1.

Port of `basisu_rs_tpu/ops/bc7.py` (`uastc_to_bc7_mode`, `_mode8_to_bc7`
and the p-bit searches), mirroring `convert_block_from_uastc` (reference:
src/target_formats/bc7.rs:9-310).  This is the function the hand-written
CUDA kernel (`csrc/uastc_bc7.cuh`) is held against: the CPU tests use it,
and `chip_smoke.py` compares the kernel with it on the card.  The kernel
wrapper (`ops/kernels.py`) reaches it only for tensors on the CPU.

Words are int64 tensors holding 0..2^32-1 (see bits.py).  Unique p-bits run
in pure integers; shared p-bits keep the reference's IEEE-f32 error sums,
each multiply and add a separate eager op, folded in the reference's order.
"""

from __future__ import annotations

import torch

from ..tables import (
    BC7_MODES,
    MODES,
    ModeCfg,
    bc7_mode_of,
    device_tables,
    fam_bc7_anchors_before,
    fam_bc7_inv_relpos_packed,
    get_family,
    kernel_tables,
)
from .bits import LaneWriter, apply_rows, extract_bit_dyn, fl_div255, lane_shape, mask
from .uastc_decode import assemble_endpoint_pairs, decode_fields, decode_mode8_rgba, fam_row

I64 = torch.int64


def remap_weight_to_bc7(w, uastc_bits: int, bc7_bits: int):
    """Closed forms of convert_weights_to_bc7's LUTs (bc7.rs:377-398)."""
    if uastc_bits == bc7_bits:
        return w
    if (uastc_bits, bc7_bits) == (1, 2):
        return 3 * w
    if (uastc_bits, bc7_bits) == (2, 4):
        return 5 * w
    if (uastc_bits, bc7_bits) == (3, 4):
        return 2 * w + (w >= 4).to(I64)
    if (uastc_bits, bc7_bits) == (5, 4):
        # floor(w/2) with two spec deviations (bc7.rs:381-384)
        return (w >> 1) - (w == 14).to(I64) + (w == 17).to(I64)
    raise ValueError((uastc_bits, bc7_bits))


# Mul-shift forms of the two p-candidate quantizations per total_bits tb
# (iscalep = 2^tb - 1), pinned over e in 0..255 by tests/test_tables.py:
#   q1 = floor(e*iscalep/510)         = (e*K1) >> S1
#   q0 = floor((e*iscalep + 255)/510) = (e*K0 + B0) >> S0
XQ_MULSHIFT = {
    4: ((1928, 16), (1928, 32765, 16)),
    5: ((3983, 16), (3984, 32765, 16)),
    6: ((8096, 16), (8096, 32765, 16)),
    7: ((16320, 16), (16320, 32765, 16)),
    8: ((32768, 16), (32768, 32768, 16)),
}

# floor((e*mask + 127)/255) = (e*K + B) >> S per endpoint width, for the
# no-p-bit scale path (bc7.rs:262-272); pinned in tests/test_tables.py.
SCALE_EP_MULSHIFT = {
    4: (962, 8156, 14),
    5: (1992, 8156, 14),
    6: (4048, 8156, 14),
    7: (8160, 8156, 14),
}


def _xq_pair(total_bits: int, e):
    """Both p-candidates' quantized values for endpoint byte e, as clamped
    half-values (q0c, q1c): x0 = 2*q0c, x1 = 2*q1c + 1."""
    (K1, S1), (K0, B0, S0) = XQ_MULSHIFT[total_bits]
    h = mask(total_bits) >> 1
    q0c = torch.clamp((e * K0 + B0) >> S0, max=h)
    q1c = torch.clamp((e * K1) >> S1, max=h)
    return q0c, q1c


def _scaled_half(total_bits: int, qc, p: int):
    """Bit-replicate x = 2*qc + p to 8 bits without materializing x."""
    if total_bits < 8:
        s0 = qc << (9 - total_bits)
        if p:
            s0 = s0 | (1 << (8 - total_bits))
        return s0 | (s0 >> total_bits)
    return (qc << 1) | p if p else qc << 1


def _select_quantized(xpairs, pb, total_comps):
    m = pb == 1
    sel = [torch.where(m, xpairs[c][1], xpairs[c][0]) for c in range(total_comps)]
    return sel + [torch.zeros_like(sel[0])] * (4 - total_comps)


def determine_unique_pbits(total_comps: int, comp_bits: int, e_lo, e_hi):
    """Integer form of the reference's f32 unique p-bit search: every error
    term is an integer below 2^16, so the f32 sums are exact."""
    tb = comp_bits + 1
    x_lo = [_xq_pair(tb, e_lo[c]) for c in range(total_comps)]
    x_hi = [_xq_pair(tb, e_hi[c]) for c in range(total_comps)]
    errs = {}
    for p in (0, 1):
        el = eh = 0
        for c in range(total_comps):
            a = _scaled_half(tb, x_lo[c][p], p) - e_lo[c]
            el = el + a * a
            b = _scaled_half(tb, x_hi[c][p], p) - e_hi[c]
            eh = eh + b * b
        errs[p] = (el, eh)
    pb_lo = (errs[1][0] < errs[0][0]).to(I64)
    pb_hi = (errs[1][1] < errs[0][1]).to(I64)
    return (
        _select_quantized(x_lo, pb_lo, total_comps),
        _select_quantized(x_hi, pb_hi, total_comps),
        pb_lo,
        pb_hi,
    )


def determine_shared_pbits(total_comps: int, comp_bits: int, e_lo, e_hi):
    """The reference's IEEE-f32 shared p-bit search: terms
    (fl(s/255) - fl(v/255))^2, each product and sum rounded on its own,
    folded left in the reference's order (bc7.rs:444)."""
    tb = comp_bits + 1
    x_lo = [_xq_pair(tb, e_lo[c]) for c in range(total_comps)]
    x_hi = [_xq_pair(tb, e_hi[c]) for c in range(total_comps)]
    fv_lo = [fl_div255(e_lo[c]) for c in range(total_comps)]
    fv_hi = [fl_div255(e_hi[c]) for c in range(total_comps)]
    errs = {}
    for p in (0, 1):
        acc = None
        for c in range(total_comps):
            bl = fl_div255(_scaled_half(tb, x_lo[c][p], p)) - fv_lo[c]
            bh = fl_div255(_scaled_half(tb, x_hi[c][p], p)) - fv_hi[c]
            term = bl * bl + bh * bh
            acc = term if acc is None else acc + term
        errs[p] = acc
    sb = (errs[1] < errs[0]).to(I64)
    return (
        _select_quantized(x_lo, sb, total_comps),
        _select_quantized(x_hi, sb, total_comps),
        sb,
        sb,
    )


def _mode8_to_bc7(lanes, tables):
    """Void-extent solid colour -> BC7 mode 5 or 6 (bc7.rs:18-58, 312-375)."""
    rgba = decode_mode8_rgba(lanes)
    shape = lane_shape(lanes)
    dev = lanes.device

    # mode 6 per-p error: only extremes are lossy (bc7.rs:1133-1136)
    err0 = sum((c == 255).to(I64) for c in rgba)  # p_bit = 0
    err1 = sum((c == 0).to(I64) for c in rgba)  # p_bit = 1
    use5 = (err0 > 0) & (err1 > 0)
    best_p = (err1 < err0).to(I64)
    m5p = tables["BC7_MODE_5_OPTIMAL_PACKED"]
    m6p = tables["BC7_MODE_6_OPTIMAL_PACKED"]

    # mode 5: 6 mode bits, 2 rotation, 3x7x2 colour, 8x2 alpha, weights
    w5 = LaneWriter(shape, 4, dev)
    w5.put_const(1 << 5, 0, 6)
    ofs = 8
    for c in range(3):
        w5.put(m5p[rgba[c]], ofs, 14)
        ofs += 14
    w5.put(rgba[3] * 0x101, ofs, 16)
    ofs += 16
    w5.put_const(1, ofs, 1)  # colour weights: BC7ENC_MODE_5_OPTIMAL_INDEX
    ofs += 1
    for _ in range(15):
        w5.put_const(1, ofs, 2)
        ofs += 2

    # mode 6: 7 mode bits, 4x7x2 endpoints, 2 p-bits, 1x(3+15x4) weights
    w6 = LaneWriter(shape, 4, dev)
    w6.put_const(1 << 6, 0, 7)
    ofs = 7
    for c in range(4):
        w6.put(m6p[rgba[c] + (1 - best_p)], ofs, 14)
        ofs += 14
    w6.put(best_p * 3, ofs, 2)
    ofs += 2
    w6.put_const(5, ofs, 3)
    ofs += 3
    for _ in range(15):
        w6.put_const(5, ofs, 4)
        ofs += 4

    out = [torch.where(use5, a, b) for a, b in zip(w5.lanes, w6.lanes)]
    return out, torch.zeros(shape, dtype=torch.bool, device=dev)


def uastc_to_bc7_mode(cfg: ModeCfg, lanes):
    """int64 [N,4] UASTC words -> (list of 4 BC7 output words, err bool[N])."""
    tables = device_tables(lanes.device)
    if cfg.id == 8:
        return _mode8_to_bc7(lanes, tables)

    bc7_idx = bc7_mode_of(cfg)
    bm = BC7_MODES[bc7_idx]
    cc = bm.channel_count
    wb7 = bm.weight_bits
    wmask7 = mask(wb7)
    shape = lane_shape(lanes)
    layout = kernel_tables()[1]

    f = decode_fields(cfg, lanes, tables)
    pairs = assemble_endpoint_pairs(cfg, f.endpoints)  # [uastc subset][2][4]

    # weights, remapped to the BC7 scale (bc7.rs:87-103)
    w = [
        [remap_weight_to_bc7(f.weights[cfg.plane_count * i + p], cfg.weight_bits, wb7) for i in range(16)]
        for p in range(cfg.plane_count)
    ]

    writer = LaneWriter(shape, 4, lanes.device)
    writer.put_const(1 << bc7_idx, 0, bc7_idx + 1)
    ofs = bc7_idx + 1

    nsub7 = bm.subset_count
    e_lo = [[None] * 4 for _ in range(nsub7)]
    e_hi = [[None] * 4 for _ in range(nsub7)]

    if nsub7 != 1:
        fam_name = get_family(cfg).name
        row = fam_row(fam_name, f.pat)
        bc7_pat = tables["FAM_BC7_INDEX"][row]
        pat_packed = tables["FAM_BC7_PAT_PACKED"][row]
        subs7 = [(pat_packed >> (2 * i)) & 3 for i in range(16)]
        perm_packed = tables["FAM_PERM_PACKED"][row]

        writer.put(bc7_pat, ofs, bm.pat_bits)
        ofs += bm.pat_bits

        # permute endpoints: BC7 subset j <- UASTC subset perm[j] (bc7.rs:163-169)
        for j in range(nsub7):
            pj = (perm_packed >> (4 * j)) & 15
            for k, dst in ((0, e_lo), (1, e_hi)):
                for c in range(4):
                    v = pairs[0][k][c]
                    for s in range(1, cfg.subset_count):
                        v = torch.where(pj == s, pairs[s][k][c], v)
                    dst[j][c] = v

        # swap endpoints + invert weights where the BC7 anchor's MSB is set
        # (bc7.rs:171-195).  Subset 0's anchor (texel 0) never has it set;
        # for j >= 1 the driving bit is the raw stored MSB, read straight
        # from the block at a per-pattern position.
        relpos_np = fam_bc7_inv_relpos_packed(fam_name, cfg.weight_bits)
        base_w = cfg.field_offsets["weights"]
        inv_packed = tables["FAM_BC7_INV_RELPOS_PACKED"][
            layout.inv_relpos_base[(fam_name, cfg.weight_bits)] + f.pat
        ]
        inv = [None]
        for s in range(1, nsub7):
            entry = (inv_packed >> (8 * (s - 1))) & 0xFF
            rel_s = (relpos_np >> (8 * (s - 1))) & 63
            bit = extract_bit_dyn(
                lanes,
                (entry & 63) + base_w,
                (base_w + int(rel_s.min()), base_w + int(rel_s.max()) + 1),
            )
            inv.append((bit & (entry >> 7)).to(torch.bool))
        for j in range(1, nsub7):
            for c in range(4):
                lo, hi = e_lo[j][c], e_hi[j][c]
                e_lo[j][c] = torch.where(inv[j], hi, lo)
                e_hi[j][c] = torch.where(inv[j], lo, hi)
        inv_masks = [None] + [inv[s].to(I64) * wmask7 for s in range(1, nsub7)]
        for i in range(16):
            m = torch.zeros_like(subs7[i])
            for s in range(1, nsub7):
                m = torch.where(subs7[i] == s, inv_masks[s], m)
            w[0][i] = w[0][i] ^ m
    else:
        # Single subset: the anchor-MSB swap is statically dead (the anchor
        # is texel 0, decoded with wb-1 bits).
        for c in range(4):
            e_lo[0][c] = pairs[0][0][c]
            e_hi[0][c] = pairs[0][1][c]
        if cfg.plane_count == 2:
            # channel rotation: swap the compsel channel with alpha (bc7.rs:216-219)
            cs = f.compsel
            for dst in (e_lo[0], e_hi[0]):
                old = list(dst)
                for c in range(3):
                    dst[c] = torch.where(cs == c, old[3], old[c])
                a = old[3]
                for c in range(3):
                    a = torch.where(cs == c, old[c], a)
                dst[3] = a
            writer.put((cs + 1) & 3, ofs, 2)
            ofs += 2
            if bm.id == 4:
                ofs += 1  # index selection bit, always 0 (bc7.rs:241-244)

    # ---- p-bits / endpoint scaling (bc7.rs:249-274) ----
    pb = []
    if bm.p_bits or bm.sp_bits:
        search = determine_unique_pbits if bm.p_bits else determine_shared_pbits
        for j in range(nsub7):
            lo, hi, p0, p1 = search(cc, bm.color_bits, e_lo[j], e_hi[j])
            e_lo[j], e_hi[j] = lo, hi
            pb.append((p0, p1))
    else:

        def scale_ep(e, nbits):
            # (e*mask + 127) // 255 as one mul-add-shift
            if nbits == 8:
                return e
            K, B, S = SCALE_EP_MULSHIFT[nbits]
            return (e * K + B) >> S

        for j in range(nsub7):
            for c in range(3):
                e_lo[j][c] = scale_ep(e_lo[j][c], bm.color_bits)
                e_hi[j][c] = scale_ep(e_hi[j][c], bm.color_bits)
            if cc == 4:
                e_lo[j][3] = scale_ep(e_lo[j][3], bm.alpha_bits)
                e_hi[j][3] = scale_ep(e_hi[j][3], bm.alpha_bits)

    # ---- endpoint emission (bc7.rs:276-286): lo and hi as one field ----
    for c in range(cc):
        bits = bm.color_bits if c != 3 else bm.alpha_bits
        for j in range(nsub7):
            writer.put(e_lo[j][c] | (e_hi[j][c] << bits), ofs, 2 * bits)
            ofs += 2 * bits

    if bm.p_bits:
        for j in range(nsub7):
            writer.put((pb[j][1] << 1) | pb[j][0], ofs, 2)
            ofs += 2
    elif bm.sp_bits:
        writer.put((pb[1][0] << 1) | pb[0][0], ofs, 2)
        ofs += 2

    # ---- weight emission (bc7.rs:296-307) ----
    # Anchor texels are written with one less bit; their MSB is 0.
    if nsub7 == 1:
        for plane_w in w:
            for i in range(16):
                bits_i = wb7 - 1 if i == 0 else wb7
                writer.put(plane_w[i], ofs, bits_i)
                ofs += bits_i
    else:
        # texel i lands in the static window [ofs + wb7*i - maxab_i,
        # ofs + wb7*i + wb7); a per-pattern pre-shift places it
        ab_tab = fam_bc7_anchors_before(fam_name)
        ps_packed = tables["FAM_BC7_WEIGHT_PRESHIFT_PACKED"][row]
        for i in range(16):
            col = ab_tab[:, i]
            maxab = int(col.max())
            if maxab == int(col.min()):
                writer.put(w[0][i], ofs + wb7 * i - maxab, wb7)
            else:
                ps = (ps_packed >> (2 * i)) & 3
                writer.put(w[0][i] << ps, ofs + wb7 * i - maxab, wb7 + maxab)

    return writer.lanes, f.err


def transcode_rows(mode: int, blocks, index, out, err) -> None:
    """Plain version of one K1 launch: transcode blocks[index] (all UASTC
    mode `mode`) into out[index] / err[index], in place.  index=None means
    every row."""
    apply_rows(lambda lanes: uastc_to_bc7_mode(MODES[mode], lanes), blocks, index, out, err)
