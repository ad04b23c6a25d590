// K4 and K5 per-block logic: one UASTC 4x4 block -> an 8-byte ETC1 block
// (uastc_to_etc1<M>) or a 16-byte ETC2 RGBA block, the EAC alpha block and
// then the ETC1 block (uastc_to_etc2<M>), specialised per UASTC mode.
//
// Port of basisu_rs_tpu/ops/etc.py (uastc_to_etc1_mode, uastc_to_etc2_mode),
// mirroring convert_block_from_uastc (reference:
// src/target_formats/etc.rs:32-341).  The texels come from K3's decode
// (decode_block in uastc_rgba.cuh), through a table of each RGB key's
// colour or texel_channels a texel; the plain PyTorch version is
// basisu_rs_tpu_torch/ops/etc.py.  Like the other .cuh files, this source
// also compiles with g++ for the CPU tests.
//
// Traps this code is written against:
//   - The EAC centre lerp min*(1-frac) + max*frac takes one IEEE rounding a
//     step (fsub_rn, fmul_rn, fadd_rn; nvcc --fmad=false, g++
//     -ffp-contract=off); frac is read from its f32 bit pattern.
//   - Mode 8 in individual mode writes ((c << 4) | c) & 0xFF: a 5-bit c of
//     16 or more wraps, as the reference's u8 write does.
//   - The bias rule's wraps at v == 0, v == limit and plain < 0, and the
//     signed clip(c1 - c0, -4, 3) & 7, stay in int32_t.
//   - Two transposes: the ETC1 selector of texel u goes to pixel id
//     (u%4)*4 + u/4, the EAC selector of texel i to pid = y*4 + x with
//     x = i/4, y = i%4.
//   - The 16 three-bit EAC selectors of the 48-bit payload accumulate in
//     two 24-bit halves (pids 0-7 and 8-15), so no field straddles a 32-bit
//     word.
//   - An alpha key's selector stands for every texel of that key only
//     because the alpha is a function of (subset, weight) alone; the EAC
//     range (min, max) is over the keys present, not over all keys.
//   - The packed quad sums hold 10-bit lanes (a quad sum is at most 1020);
//     a subblock's sums (at most 2040) add r and b in one word and g in
//     another, so no lane carries into the next.
#pragma once
#include <string.h>

#include "uastc_rgba.cuh"

namespace ub {

UB_FN int32_t color_5_to_8(int32_t c) { return (c << 3) | (c >> 2); }
UB_FN int32_t color_4_to_8(int32_t c) { return (c << 4) | c; }

UB_FN float bits_to_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// ETC1 wire bits of a 2-bit selector: SELECTOR_ID_TO_ETC1[sel] =
// [3, 2, 0, 1][sel], its MSB !(sel>>1) and LSB !((sel>>1) ^ (sel&1)).
UB_FN void selector_ms_ls(uint32_t sel, uint32_t& ms, uint32_t& ls) {
  const uint32_t hi = (sel >> 1) & 1u;
  ms = hi ^ 1u;
  ls = (hi ^ sel ^ 1u) & 1u;
}

// The wire bits of a texel's selector from its luminance and its
// subblock's three non-decreasing thresholds, each as the sign bit (bit 31)
// of a word: the hits c1 >= c2 >= c3 are nested, sel = c1 + c2 + c3, so
// ms = !c2 = lum < th[1] and ls = c3 | !c1 = lum >= th[2] || lum < th[0].
// Luminances and thresholds lie in 0..130,560, so no difference overflows.
UB_FN uint32_t etc1_ms_sign(int32_t lum, const int32_t (&th)[3]) { return static_cast<uint32_t>(lum - th[1]); }

UB_FN uint32_t etc1_ls_sign(int32_t lum, const int32_t (&th)[3]) {
  return static_cast<uint32_t>(lum - th[0]) | ~static_cast<uint32_t>(lum - th[2]);
}

// The ETC1 selector word (etc.rs:363-393) of 16 texels (raster order u =
// y*4 + x) from their luminances and the thresholds of their 2x2 quads
// (qy*2 + qx).  Texel u sits at pixel id (u%4)*4 + u/4; byte 0 holds the
// MSBs of pixel ids 8..15, byte 1 those of 0..7, bytes 2 and 3 the LSBs
// likewise.  Each wire bit is shifted in from the sign of its word (one
// SHF.L.W), LSBs first, each half in pixel-id order 7..0, 15..8, so the
// last bit of a half (pixel id 8) lands at its bit 0: no compare, no
// select, no per-bit placement.
UB_FN uint32_t etc1_selector_word(const int32_t (&lum)[16], const int32_t (&tq)[4][3]) {
  uint32_t w = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int pid = j < 8 ? 7 - j : 23 - j;
      const int u = (pid % 4) * 4 + pid / 4, qd = (u / 8) * 2 + (u % 4) / 2;
      w = funnel_shl(half == 0 ? etc1_ls_sign(lum[u], tq[qd]) : etc1_ms_sign(lum[u], tq[qd]), w, 1);
    }
  }
  return w;
}

// The ETC hint fields (uastc.rs:411-441).  Modes 10-12 carry no bc1h1 and
// no bias; only the alpha formats carry etc2tm.
struct EtcFlags {
  int32_t flip, diff, inten0, inten1, bias, etc2tm;
};

template <int M>
UB_FN EtcFlags decode_trans_flags(const uint32_t (&l)[4]) {
  using C = Mode<M>;
  constexpr bool no_bias = M >= 10 && M <= 12;
  constexpr int ofs = C::ofs_trans_flags + (no_bias ? 1 : 2);  // past bc1h0 (and bc1h1)
  EtcFlags f;
  f.flip = static_cast<int32_t>(extract(l, ofs, 1));
  f.diff = static_cast<int32_t>(extract(l, ofs + 1, 1));
  f.inten0 = static_cast<int32_t>(extract(l, ofs + 2, 3));
  f.inten1 = static_cast<int32_t>(extract(l, ofs + 5, 3));
  f.bias = no_bias ? 0 : static_cast<int32_t>(extract(l, ofs + 8, 5));
  f.etc2tm = C::format == FORMAT_RGB ? 0 : static_cast<int32_t>(extract(l, ofs + (no_bias ? 8 : 13), 8));
  return f;
}

// ---- EAC alpha block (etc.rs:261-341) -------------------------------------

// The solid EAC block of an alpha byte: table 13, multiplier 1, every
// selector 4.
UB_FN void solid_alpha_block(uint32_t value, uint32_t& w0, uint32_t& w1) {
  w0 = value | (0x1Du << 8) | (0x92u << 16) | (0x49u << 24);
  w1 = 0x24u | (0x92u << 8) | (0x49u << 16) | (0x24u << 24);
}

// The 7 thresholds of the EAC selector search for a block's centre,
// multiplier and modifier row (m0, m1: the row's 8 modifiers + 15, a byte
// each).  The candidates in value order [3,2,1,0,4,5,6,7] take pre-halved
// midpoint thresholds, and the two duplicate-run shapes of min_by_key's
// first-minimal-j rule (mult == 0: all equal; W3 == W4) are folded into
// the thresholds once per block.
UB_FN void eac_thresholds(int32_t center, int32_t mult, uint32_t m0, uint32_t m1, int32_t (&T)[7]) {
  const int32_t cbase = center - 15 * mult;
  int32_t val[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int32_t mod = static_cast<int32_t>(((j < 4 ? m0 : m1) >> (8 * (j & 3))) & 255u);
    val[j] = imin(imax(cbase + mod * mult, 0), 255);
  }
  const int32_t W[8] = {val[3], val[2], val[1], val[0], val[4], val[5], val[6], val[7]};
#pragma unroll
  for (int k = 0; k < 7; ++k) T[k] = (W[k] + W[k + 1] + (k < 3 ? 1 : 2)) >> 1;
  const bool kill_all = mult == 0, kill_lo = kill_all || W[3] == W[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) T[k] = kill_lo ? 0 : T[k];
#pragma unroll
  for (int k = 4; k < 7; ++k) T[k] = kill_all ? 256 : T[k];
  T[3] = kill_lo ? T[4] : T[3];
}

// The thresholds of a block as lane constants of eac_selector: three
// 10-bit lanes 255 + T[k] (k = 0..2), three of 2 * (256 - T[k]) (k = 4..6)
// and 256 - T[3].
struct EacLanes {
  uint32_t lo, hi, mid;
};

UB_FN EacLanes eac_lanes(const int32_t (&T)[7]) {
  EacLanes e;
  e.lo = static_cast<uint32_t>(255 + T[0]) | (static_cast<uint32_t>(255 + T[1]) << 10) |
         (static_cast<uint32_t>(255 + T[2]) << 20);
  e.hi = (static_cast<uint32_t>(256 - T[4]) << 1) | (static_cast<uint32_t>(256 - T[5]) << 11) |
         (static_cast<uint32_t>(256 - T[6]) << 21);
  e.mid = static_cast<uint32_t>(256 - T[3]);
  return e;
}

// The EAC selector (0..7) of alpha a.  The thresholds are non-decreasing,
// so the hits a >= T[k] form a run from k = 0: below T[3] the selector is
// the count of misses among T[0..2] (3 - rank), from T[3] up it is 4 plus
// the hits among T[4..6].  Each lane of one multiply-add holds a - T[k]
// offset to stay within 0..1023, so its bit 8 (bit 9 in the doubled lanes)
// is the miss or hit; the selector is the popcount of those bits, T[3]'s
// hit counted four times.  No compare, no predicate.
UB_FN uint32_t eac_selector(int32_t a, const EacLanes& e) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t miss = e.lo - ua * 0x100401u;    // 255 + T[k] - a: bit 8 = a < T[k]
  const uint32_t hit = ua * 0x200802u + e.hi;     // 2 (a + 256 - T[k]): bit 9 = a >= T[k]
  const uint32_t hit3 = (ua + e.mid) & 0x100u;    // a + 256 - T[3]: bit 8 = a >= T[3]
  return popc((miss & 0x10040100u) | (hit & 0x20080200u) | (hit3 * 0x3Cu));  // hit3: bits 10-13
}

// The EAC centre round(lerp(min, max, frac)) of table tbl, half away from
// zero (>= 0 here), one IEEE rounding a step.
UB_FN int32_t eac_center(int32_t tbl, int32_t amin, int32_t amax) {
  const float frac = bits_to_float(UB_LDG(&EAC_FRACTION_BITS[tbl]));
  const float lerped = fadd_rn(fmul_rn(static_cast<float>(amin), fsub_rn(1.0f, frac)),
                               fmul_rn(static_cast<float>(amax), frac));
  return static_cast<int32_t>(fadd_rn(lerped, 0.5f));  // truncation
}

// The EAC block's two words from its centre, etc2tm and the selector
// payload in two halves (bits 47..24 and 23..0 of the 48-bit payload).  The
// solid overrides (min == max, then etc2tm == 0) come last, as in the
// reference, so every thread runs the same straight-line code.
UB_FN void eac_words(int32_t center, int32_t etc2tm, uint32_t hi24, uint32_t lo24, int32_t amin, int32_t amax,
                     uint32_t& w0, uint32_t& w1) {
  // block byte b (2..7) is payload bits 47-8(b-2) .. 40-8(b-2)
  const uint32_t hi = hi24 >> 8, lo = (hi24 << 24) | lo24;
  w0 = (static_cast<uint32_t>(center) & 0xFFu) | (static_cast<uint32_t>(etc2tm) << 8) |
       ((hi & 0xFF00u) << 8) | ((hi & 0xFFu) << 24);
  w1 = (lo >> 24) | ((lo >> 8) & 0xFF00u) | ((lo & 0xFF00u) << 8) | ((lo & 0xFFu) << 24);
  if (amin == amax) solid_alpha_block(static_cast<uint32_t>(amin), w0, w1);
  if (etc2tm == 0) solid_alpha_block(255u, w0, w1);
}

// Alpha keys: a texel's alpha is a function of its subset and its
// alpha-plane weight alone, so the key (subset << weight_bits) | weight
// names it.  The alpha reads plane 1 where the component selector is 3.
template <int M>
UB_FN uint32_t alpha_key(const uint32_t (&l)[4], const BlockLerp<M>& b, int i) {
  using C = Mode<M>;
  uint32_t w = texel_weight<M>(l, b.abp, i, 0);
  if constexpr (C::planes == 2) w = b.cs == 3 ? texel_weight<M>(l, b.abp, i, 1) : w;
  if constexpr (C::subsets > 1) w |= static_cast<uint32_t>(texel_subset<M>(b, i)) << C::weight_bits;
  return w;
}

// The alpha of key k, from b's alpha lerp.
template <int M>
UB_FN int32_t alpha_of_key(const BlockLerp<M>& b, uint32_t k) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits;
  const uint32_t s = k >> wb;
  int32_t l0 = b.L0[0][3], d = b.D[0][3];
#pragma unroll
  for (int t = 1; t < C::subsets; ++t) {
    l0 = s == static_cast<uint32_t>(t) ? b.L0[t][3] : l0;
    d = s == static_cast<uint32_t>(t) ? b.D[t][3] : d;
  }
  return interp_eval(l0, d, unquant_weight<wb>(static_cast<int32_t>(k & mask(wb))));
}

// The selector of key k from a table of one selector byte a key (byte k of
// the table is key k's), by one PRMT.
template <int NKEYS>
UB_FN uint32_t key_selector(const uint32_t (&tab)[2], uint32_t k) {
  if constexpr (NKEYS <= 4) {
    return byte_perm(tab[0], 0u, k | 0x4440u);  // the upper bytes read the zero word
  } else {
    static_assert(NKEYS <= 8, "at most 8 keys");
    return byte_perm(tab[0], tab[1], k) & 0xFFu;
  }
}

// ---- the ETC1 block --------------------------------------------------------

// Mode 8: the ETC1 block straight from the hint flags (etc.rs:43-75).
UB_FN uint32_t mode8_color_byte(uint32_t c, uint32_t d) { return d ? c << 3 : ((c << 4) | c) & 0xFFu; }

UB_FN void mode8_etc1(const uint32_t (&l)[4], uint32_t& w0, uint32_t& w1) {
  constexpr int O = MODE8_ETC1_FLAGS_OFFSET;
  const uint32_t d = extract(l, O, 1), inten = extract(l, O + 1, 3), s = extract(l, O + 4, 2);
  w0 = mode8_color_byte(extract(l, O + 6, 5), d) | (mode8_color_byte(extract(l, O + 11, 5), d) << 8) |
       (mode8_color_byte(extract(l, O + 16, 5), d) << 16) | (((inten << 5) | (inten << 2) | (d << 1)) << 24);
  uint32_t ms, ls;
  selector_ms_ls(s, ms, ls);
  w1 = (0xFFFFu * ms) | ((0xFFFFu * ls) << 16);
}

// (ssum*limit + 1020) / 2040, the subblock average of a channel sum
// (ssum <= 2040, limit 15 or 31), as an exact mul-shift: the product is at
// most 64260 * 32897 < 2^31.
UB_FN int32_t subblock_average(int32_t ssum, int32_t limit) { return ((ssum * limit + 1020) * 32897) >> 26; }

// The bias nudge of one channel (etc.rs:203-259); field = delta + 2.  The
// three cases are selects, the first that holds last, so the six nudges
// of a block take no branch.
UB_FN int32_t apply_bias(int32_t v, int32_t field, int32_t limit) {
  const int32_t plain = v + field - 2;
  int32_t r = plain < 0 ? v + 2 : plain;  // only plain == -1 (v 1, delta -2) wraps
  r = v == limit ? plain - 1 : r;
  return v == 0 ? (field - 1) & 3 : r;  // delta + 1, except delta -2 -> 3
}

// A texel's RGB packed for the 2x2-quad sums, r | g << 10 | b << 20: a
// quad's sum is at most 1020 a lane, so one add a texel sums all three.
UB_FN uint32_t pack_quad_rgb(int32_t r, int32_t g, int32_t b) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 10) | (static_cast<uint32_t>(b) << 20);
}

// The ETC1 block of a non-mode-8 block from its flags, the four packed
// 2x2-quad RGB sums q[qy*2 + qx] and the 16 texel luminances
// (etc.rs:78-200).  Each texel u writes its selector at the static pixel id
// (u%4)*4 + u/4 in both orientations; the flip bit only chooses whose
// thresholds it meets (its row pair under flip, its column pair otherwise),
// which differ only on the two off-diagonal quads.
template <int M>
UB_FN void etc1_block(const EtcFlags& f, const uint32_t (&q)[4], const int32_t (&lum)[16], uint32_t& w0,
                      uint32_t& w1) {
  constexpr bool has_bias = !(M >= 10 && M <= 12);
  const bool flip = f.flip != 0, diff = f.diff != 0;
  const int32_t limit = diff ? 31 : 15;
  const uint32_t bias_word = has_bias ? UB_LDG(&ETC_BIAS_PACKED[f.bias]) : 0u;
  int32_t c[2][3];
#pragma unroll
  for (int sb = 0; sb < 2; ++sb) {
    // subblock sb is quads {0, 1} / {2, 3} under flip, {0, 2} / {1, 3}
    // otherwise; its sums (at most 2040) add r and b in one word, g in another
    const uint32_t x = q[3 * sb], y = sb == 0 ? (flip ? q[1] : q[2]) : (flip ? q[2] : q[1]);
    const uint32_t rb = (x & 0x3FF003FFu) + (y & 0x3FF003FFu), g = (x & 0xFFC00u) + (y & 0xFFC00u);
    const int32_t ssums[3] = {static_cast<int32_t>(rb & 0x7FFu), static_cast<int32_t>(g >> 10),
                              static_cast<int32_t>(rb >> 20)};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int32_t avg = subblock_average(ssums[ch], limit);
      c[sb][ch] = has_bias ? apply_bias(avg, static_cast<int32_t>((bias_word >> (2 * (3 * sb + ch))) & 3u), limit)
                           : avg;
    }
  }
  // colour bytes and palette bases (etc.rs:122-149)
  int32_t base[2][3];
  uint32_t bytes = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int32_t d = imin(imax(c[1][ch] - c[0][ch], -4), 3);
    const int32_t byte = diff ? (c[0][ch] << 3) | (d & 7) : (c[0][ch] << 4) | c[1][ch];
    bytes |= static_cast<uint32_t>(byte) << (8 * ch);
    base[0][ch] = diff ? color_5_to_8(c[0][ch]) : color_4_to_8(c[0][ch]);
    base[1][ch] = diff ? color_5_to_8(c[0][ch] + d) : color_4_to_8(c[1][ch]);
  }
  w0 = bytes | (static_cast<uint32_t>((f.inten0 << 5) | (f.inten1 << 2) | (f.diff << 1) | f.flip) << 24);

  // palette luminances at half scale (54/183/19): the reference's
  // (lum_k + lum_k+1) >> 1 of even full-scale values is the plain sum
  int32_t th[2][3];
#pragma unroll
  for (int sb = 0; sb < 2; ++sb) {
    const uint32_t mw = UB_LDG(&ETC1_MOD_PACKED[sb == 0 ? f.inten0 : f.inten1]);
    const int32_t small = static_cast<int32_t>(mw & 255u), big = static_cast<int32_t>(mw >> 8);
    int32_t pl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t mod = k == 0 ? -big : k == 1 ? -small : k == 2 ? small : big;
      int32_t s = 0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int32_t v = k < 2 ? imax(base[sb][ch] + mod, 0) : imin(base[sb][ch] + mod, 255);
        s += v * (ch == 0 ? 54 : ch == 1 ? 183 : 19);
      }
      pl[k] = s;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) th[sb][k] = pl[k] + pl[k + 1];
  }
  // thresholds per quad qy*2 + qx, the off-diagonal ones chosen once per block
  int32_t tq[4][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tq[0][k] = th[0][k];
    tq[1][k] = flip ? th[0][k] : th[1][k];
    tq[2][k] = flip ? th[1][k] : th[0][k];
    tq[3][k] = th[1][k];
  }
  w1 = etc1_selector_word(lum, tq);
}

UB_FN int32_t texel_luminance(int32_t r, int32_t g, int32_t b) { return r * 108 + g * 366 + b * 38; }

// Fold texel i's RGB into the ETC1 inputs: its packed 2x2-quad sum and its
// luminance.
UB_FN void fold_texel(int i, const int32_t (&ch)[4], uint32_t (&q)[4], int32_t (&lum)[16]) {
  q[(i / 8) * 2 + (i % 4) / 2] += pack_quad_rgb(ch[0], ch[1], ch[2]);
  lum[i] = texel_luminance(ch[0], ch[1], ch[2]);
}

// ---- RGB key tables --------------------------------------------------------
//
// A texel's RGB is a function of its key alone: (subset << wb) | weight in
// a single-plane mode, (plane-1 weight << wb) | plane-0 weight in a
// dual-plane one.  Where a mode has at most kMaxRgbKeys keys, the block's
// lerp runs once a key, with the subset and the weight known at compile
// time (no subset select, the unquantized weight an immediate), into a
// table of (packed quad RGB, luminance) a key; each texel then costs its
// key, one 8-byte load and one add.  Every mode but 18 (32 keys) takes the
// table: at 16 keys (4-bit weights, two 3-bit subsets, two 2-bit planes)
// it was faster than the lerp a texel in one A/B run (tools/csrc_ab.py;
// PERF.md).
constexpr int kMaxRgbKeys = 16;

template <int M>
struct RgbKeys {
  using C = Mode<M>;
  static constexpr int count = C::planes == 2 ? 1 << (2 * C::weight_bits) : C::subsets << C::weight_bits;
  static constexpr bool tabled = M != 8 && count <= kMaxRgbKeys;
};

// Texel i's RGB key from the block's weight stream st (weight_stream) and
// subset map sp: its weights, both planes, are one field of the stream.
template <int M>
UB_FN uint32_t rgb_key(const uint32_t (&st)[4], uint32_t sp, int i) {
  using C = Mode<M>;
  constexpr int kb = C::planes * C::weight_bits;
  const uint32_t w = extract(st, kb * i, kb);
  if constexpr (C::subsets > 1) return w | (((sp >> (2 * i)) & 3u) << C::weight_bits);
  else return w;
}

// The RGB of key k (compile-time after unrolling) from b's lerp.
template <int M>
UB_FN void key_rgb(const BlockLerp<M>& b, int k, int32_t (&ch)[3]) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits;
  const int32_t u0 = unquant_weight<wb>(k & ((1 << wb) - 1));
  if constexpr (C::planes == 2) {
    const int32_t u1 = unquant_weight<wb>(k >> wb);
#pragma unroll
    for (int c = 0; c < 3; ++c) ch[c] = interp_eval(b.L0[0][c], b.D[0][c], b.cs == c ? u1 : u0);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) ch[c] = interp_eval(b.L0[k >> wb][c], b.D[k >> wb][c], u0);
  }
}

// A thread's key table.  On the card: column threadIdx.x of a [key][thread]
// array in shared memory, 8 bytes an entry, so the 8-byte loads of a
// half-warp, whatever keys they name, meet 32 distinct banks (32 KiB a CTA
// at 16 keys).  On the host: two arrays.
#if defined(__CUDA_ARCH__)
template <int N>
__device__ __forceinline__ uint2* rgb_key_column() {
  __shared__ uint2 table[N * kThreads];
  return table + threadIdx.x;
}

template <int N>
struct RgbKeyTable {
  uint2* col;
  __device__ __forceinline__ RgbKeyTable() : col(rgb_key_column<N>()) {}
  __device__ __forceinline__ void set(int k, uint32_t rgb, int32_t lum) {
    col[k * kThreads] = make_uint2(rgb, static_cast<uint32_t>(lum));
  }
  __device__ __forceinline__ void get(uint32_t k, uint32_t& rgb, int32_t& lum) const {
    const uint2 e = col[k * kThreads];
    rgb = e.x;
    lum = static_cast<int32_t>(e.y);
  }
};
#else
template <int N>
struct RgbKeyTable {
  uint32_t rgbs[N];
  int32_t lums[N];
  void set(int k, uint32_t rgb, int32_t lum) {
    rgbs[k] = rgb;
    lums[k] = lum;
  }
  void get(uint32_t k, uint32_t& rgb, int32_t& lum) const {
    rgb = rgbs[k];
    lum = lums[k];
  }
};
#endif

// Fill t with every key's (packed quad RGB, luminance) of b's lerp.
template <int M>
UB_FN void fill_rgb_keys(const BlockLerp<M>& b, RgbKeyTable<RgbKeys<M>::count>& t) {
#pragma unroll
  for (int k = 0; k < RgbKeys<M>::count; ++k) {
    int32_t ch[3];
    key_rgb<M>(b, k, ch);
    t.set(k, pack_quad_rgb(ch[0], ch[1], ch[2]), texel_luminance(ch[0], ch[1], ch[2]));
  }
}

// Stream the block's texels into the ETC1 inputs (packed quad sums,
// luminances): through the key table where the mode has one, else the
// lerp a texel.
template <int M>
UB_FN bool etc_texels(const uint32_t (&l)[4], uint32_t (&q)[4], int32_t (&lum)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = 0;
  if constexpr (RgbKeys<M>::tabled) {
    BlockLerp<M> b;
    const bool err = decode_block<M, 3>(l, b);
    int32_t pat;
    decode_pattern<M>(l, pat);
    uint32_t st[4];
    weight_stream<M>(l, pat, st);
    RgbKeyTable<RgbKeys<M>::count> t;
    fill_rgb_keys<M>(b, t);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t rgb;
      t.get(rgb_key<M>(st, b.sp, i), rgb, lum[i]);
      q[(i / 8) * 2 + (i % 4) / 2] += rgb;
    }
    return err;
  } else {
    return for_each_texel<M, 3>(l, [&](int i, const int32_t (&ch)[4]) { fold_texel(i, ch, q, lum); });
  }
}

// The EAC block of an alpha mode's block (M not 8, alpha format) and the
// ETC1 inputs, in two passes over the texels.  Pass 1 folds each texel's
// RGB into the ETC1 inputs and takes its alpha key; the lerp is monotone in
// the weight, so the alpha range is that of the lowest and highest weight
// present in each subset.  Then each key's alpha gets its selector once, in
// a byte table, and pass 2 looks each texel's key up (one PRMT) and places
// its selector; with 16 keys (4-bit weights) pass 2 searches each texel's
// alpha instead.  No texel's alpha is kept.
template <int M>
UB_FN bool etc2_alpha_texels(const uint32_t (&l)[4], int32_t etc2tm, uint32_t (&q)[4], int32_t (&lum)[16],
                             uint32_t& w0, uint32_t& w1) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits, nkeys = C::subsets << wb;
  BlockLerp<M> b;
  const bool err = decode_block<M, 4>(l, b);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = 0;
  uint32_t kmin = nkeys - 1, kmax = 0, present = 0;  // one subset: key range; two: keys present
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int32_t ch[4];
    texel_channels<M, 3>(l, b, i, ch);
    fold_texel(i, ch, q, lum);
    const uint32_t k = alpha_key<M>(l, b, i);
    if constexpr (C::subsets == 1) {
      kmin = k < kmin ? k : kmin;
      kmax = k > kmax ? k : kmax;
    } else {
      present |= 1u << k;
    }
  }
  int32_t amin = 255, amax = 0;
#pragma unroll
  for (int s = 0; s < C::subsets; ++s) {
    uint32_t lo = kmin, hi = kmax;
    if constexpr (C::subsets > 1) {
      const uint32_t keys = (present >> (s << wb)) & mask(1 << wb);  // every subset holds a texel
      lo = (static_cast<uint32_t>(s) << wb) | static_cast<uint32_t>(low_bit(keys));
      hi = (static_cast<uint32_t>(s) << wb) | static_cast<uint32_t>(high_bit(keys));
    }
    const int32_t a0 = alpha_of_key<M>(b, lo), a1 = alpha_of_key<M>(b, hi);
    amin = imin(amin, imin(a0, a1));
    amax = imax(amax, imax(a0, a1));
  }
  const int32_t tbl = etc2tm & 15, mult = etc2tm >> 4;
  const int32_t center = eac_center(tbl, amin, amax);
  int32_t T[7];
  eac_thresholds(center, mult, UB_LDG(&EAC_MOD_PACKED[2 * tbl]), UB_LDG(&EAC_MOD_PACKED[2 * tbl + 1]), T);
  const EacLanes lanes = eac_lanes(T);
  uint32_t tab[2] = {0, 0};  // up to 8 keys: one selector byte a key
  if constexpr (nkeys <= 8) {
#pragma unroll
    for (int k = 0; k < nkeys; ++k) tab[k / 4] |= eac_selector(alpha_of_key<M>(b, k), lanes) << (8 * (k % 4));
  }
  uint32_t hi24 = 0, lo24 = 0;  // payload bits 47..24 (pids 0-7) and 23..0 (pids 8-15)
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t k = alpha_key<M>(l, b, i);
    uint32_t sel;
    if constexpr (nkeys <= 8) sel = key_selector<nkeys>(tab, k);
    else sel = eac_selector(alpha_of_key<M>(b, k), lanes);  // 16 keys: a table costs more than a search a texel
    const int pid = (i % 4) * 4 + i / 4;  // x = i/4, y = i%4
    if (pid < 8) hi24 |= sel << (21 - 3 * pid);
    else lo24 |= sel << (21 - 3 * (pid - 8));
  }
  eac_words(center, etc2tm, hi24, lo24, amin, amax, w0, w1);
  return err;
}

// UASTC block -> ETC1 block (2 words).  Returns the block's error flag.
template <int M>
UB_FN bool uastc_to_etc1(const uint32_t (&l)[4], uint32_t (&o)[2]) {
  if constexpr (M == 8) {
    mode8_etc1(l, o[0], o[1]);
    return false;
  } else {
    uint32_t q[4];
    int32_t lum[16];
    const bool err = etc_texels<M>(l, q, lum);
    etc1_block<M>(decode_trans_flags<M>(l), q, lum, o[0], o[1]);
    return err;
  }
}

// UASTC block -> ETC2 RGBA block (4 words: EAC alpha, then ETC1).
template <int M>
UB_FN bool uastc_to_etc2(const uint32_t (&l)[4], uint32_t (&o)[4]) {
  if constexpr (M == 8) {
    solid_alpha_block(extract(l, MODE8_RGBA_OFFSET + 24, 8), o[0], o[1]);
    mode8_etc1(l, o[2], o[3]);
    return false;
  } else {
    uint32_t q[4];
    int32_t lum[16];
    const EtcFlags f = decode_trans_flags<M>(l);
    bool err;
    if constexpr (Mode<M>::format != FORMAT_RGB) {
      err = etc2_alpha_texels<M>(l, f.etc2tm, q, lum, o[0], o[1]);
    } else {
      // RGB modes decode alpha 255 and carry no etc2tm: the solid-255 block
      err = etc_texels<M>(l, q, lum);
      solid_alpha_block(255u, o[0], o[1]);
    }
    etc1_block<M>(f, q, lum, o[2], o[3]);
    return err;
  }
}

}  // namespace ub
