// K6-K9 per-block logic: one ETC1S block, given its gathered codebook
// words, -> a row of 4 packed texels (K6 RGBA, K7 alpha, K8 RGBA with the
// alpha slice's G as alpha) or an 8-byte ETC1 block (K9).
//
// Port of basisu_rs_tpu/ops/etc1s.py (etc1s_rgba_kernel, etc1s_alpha_kernel,
// etc1s_etc1_kernel) and of the fused body of ops/etc1s_pallas.py
// (_rgba_alpha_kernel_body), mirroring the per-block closures of the
// reference (src/basis_lz/mod.rs:97-186).  The plain PyTorch version is
// basisu_rs_tpu_torch/ops/etc1s.py.  Like the other .cuh files, this source
// also compiles with g++ for the CPU tests.
//
// Codebook words (ops/etc1s.py packers): endpoint r5 | g5 << 5 | b5 << 10 |
// inten << 15; selector: row y at byte y, texel x at bits 2x of it; wire:
// the ETC1 selector word of the entry.
//
// Traps this code is written against:
//   - The palette rows are [-big, -small, small, big]: levels 0-1 clamp at
//     0 only, levels 2-3 at 255 only, in int32_t (base - big goes negative).
//   - The texel order of K6-K8 is row-major (i = 4y + x, selector byte y),
//     while the ETC1 wire word of K9 is column-major (pixel id 4x + y); the
//     host computes the wire words, so the kernel only gathers them.
//   - K9's lane 0 stores each 5-bit colour << 3 (a differential block with
//     zero deltas), not the expanded palette base, and the byte
//     (inten << 5) | (inten << 2) | 0b11.
//   - K8's RGB words carry no 0xFF000000; the alpha byte is the G of the
//     alpha slice's palette colour, << 24.
#pragma once
#include "uastc_etc.cuh"

namespace ub {

enum : int { ETC1S_RGBA = 0, ETC1S_ALPHA = 1, ETC1S_RGBA_ALPHA = 2, ETC1S_ETC1 = 3, ETC1S_KINDS = 4 };

// Codebook word `i` of a table of n >= 1 words.  The wrapper refuses an
// index past the end unless its caller vouches for the range; an index past
// the end reads the last word, so no launch reads outside the table.
UB_FN uint32_t etc1s_word(const uint32_t* tab, uint32_t n, uint32_t i) { return UB_LDG(tab + (i < n ? i : n - 1)); }

// The 4-colour palette of an endpoint word, per level k: the packed RGB
// bytes (rgb[k]) and the G value (g[k]).
UB_FN void etc1s_palette(uint32_t ep, uint32_t (&rgb)[4], uint32_t (&g)[4]) {
  const uint32_t mw = UB_LDG(&ETC1_MOD_PACKED[(ep >> 15) & 7u]);
  const int32_t small = static_cast<int32_t>(mw & 255u), big = static_cast<int32_t>(mw >> 8);
  uint32_t ch[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int32_t base = color_5_to_8(static_cast<int32_t>((ep >> (5 * c)) & 31u));
    ch[c][0] = static_cast<uint32_t>(imax(base - big, 0));
    ch[c][1] = static_cast<uint32_t>(imax(base - small, 0));
    ch[c][2] = static_cast<uint32_t>(imin(base + small, 255));
    ch[c][3] = static_cast<uint32_t>(imin(base + big, 255));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rgb[k] = ch[0][k] | (ch[1][k] << 8) | (ch[2][k] << 16);
    g[k] = ch[1][k];
  }
}

// v[s] for a 2-bit s, as selects (a dynamic index would put v in local memory).
UB_FN uint32_t pick4(uint32_t s, const uint32_t (&v)[4]) {
  const uint32_t lo = (s & 1u) ? v[1] : v[0];
  const uint32_t hi = (s & 1u) ? v[3] : v[2];
  return (s & 2u) ? hi : lo;
}

// Row y (texels x = 0..3) of a K6/K7/K8 block from its codebook words: the
// endpoint and selector words, and for K8 the alpha slice's pair.
template <int KIND>
UB_FN void etc1s_row(uint32_t ep, uint32_t sel, uint32_t a_ep, uint32_t a_sel, int y, uint32_t (&o)[4]) {
  static_assert(KIND == ETC1S_RGBA || KIND == ETC1S_ALPHA || KIND == ETC1S_RGBA_ALPHA, "a texel kind");
  uint32_t rgb[4], g[4];
  etc1s_palette(ep, rgb, g);
  const uint32_t row = (sel >> (8 * y)) & 255u;
  if constexpr (KIND == ETC1S_RGBA_ALPHA) {
    uint32_t a_rgb[4], a_g[4];
    etc1s_palette(a_ep, a_rgb, a_g);
    const uint32_t a_row = (a_sel >> (8 * y)) & 255u;
#pragma unroll
    for (int x = 0; x < 4; ++x) o[x] = pick4((row >> (2 * x)) & 3u, rgb) | (pick4((a_row >> (2 * x)) & 3u, a_g) << 24);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const uint32_t s = (row >> (2 * x)) & 3u;
      o[x] = KIND == ETC1S_RGBA ? pick4(s, rgb) | 0xFF000000u : pick4(s, g);
    }
  }
}

// K9: an endpoint word and a wire word -> the two words of an ETC1 block.
UB_FN void etc1s_etc1_block(uint32_t ep, uint32_t wire, uint32_t (&o)[2]) {
  const uint32_t inten = (ep >> 15) & 7u;
  o[0] = ((ep & 31u) << 3) | (((ep >> 5) & 31u) << 11) | (((ep >> 10) & 31u) << 19) |
         (((inten << 5) | (inten << 2) | 3u) << 24);
  o[1] = wire;
}

}  // namespace ub
