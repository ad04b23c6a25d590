// K1 per-block logic: one UASTC 4x4 block -> one BC7 block, specialised per
// UASTC mode (template <int M>), so every bit offset is a compile-time
// constant and folds, as the per-mode trace folds them in the JAX package.
//
// Port of basisu_rs_tpu/ops/bc7.py (uastc_to_bc7_mode, _mode8_to_bc7, the
// p-bit searches); the shared UASTC decode is in uastc_decode.cuh.  The plain
// PyTorch version is basisu_rs_tpu_torch/ops/bc7.py.  Like uastc_decode.cuh,
// this source also compiles with g++ for the CPU tests.
#pragma once
#include "uastc_decode.cuh"

namespace ub {

// ---- BC7 helpers (ops/bc7.py) ---------------------------------------------

// convert_weights_to_bc7's LUTs as closed forms (bc7.rs:377-398)
template <int UB, int B7>
UB_FN uint32_t remap_weight(uint32_t w) {
  if constexpr (UB == B7) return w;
  else if constexpr (UB == 1 && B7 == 2) return 3u * w;
  else if constexpr (UB == 2 && B7 == 4) return 5u * w;
  else if constexpr (UB == 3 && B7 == 4) return 2u * w + (w >= 4u ? 1u : 0u);
  else {
    static_assert(UB == 5 && B7 == 4, "no such weight remap");
    return (w >> 1) - (w == 14u ? 1u : 0u) + (w == 17u ? 1u : 0u);
  }
}

// Both p-candidates' quantized endpoint as clamped half-values:
// q0c = min(floor((e*iscalep + 255)/510), h), q1c = min(floor(e*iscalep/510), h)
// as mul-shifts (XQ_MULSHIFT in ops/bc7.py).
template <int TB>
UB_FN void xq_pair(int32_t e, int32_t& q0c, int32_t& q1c) {
  constexpr int K1 = TB == 4 ? 1928 : TB == 5 ? 3983 : TB == 6 ? 8096 : TB == 7 ? 16320 : 32768;
  constexpr int K0 = TB == 4 ? 1928 : TB == 5 ? 3984 : TB == 6 ? 8096 : TB == 7 ? 16320 : 32768;
  constexpr int B0 = TB == 8 ? 32768 : 32765;
  constexpr int S = 16;
  constexpr int h = ((1 << TB) - 1) >> 1;
  const int32_t a = (e * K0 + B0) >> S, b = (e * K1) >> S;
  q0c = a < h ? a : h;
  q1c = b < h ? b : h;
}

// x = 2*qc + p bit-replicated to 8 bits
template <int TB>
UB_FN int32_t scaled_half(int32_t qc, int p) {
  if constexpr (TB < 8) {
    int32_t s0 = qc << (9 - TB);
    if (p) s0 |= 1 << (8 - TB);
    return s0 | (s0 >> TB);
  } else {
    return (qc << 1) | p;
  }
}

// Unique p-bits: the reference's f32 error terms are integers < 2^16 here,
// so the search is exact in int32.
template <int CC, int CB>
UB_FN void unique_pbits(int32_t (&lo)[4], int32_t (&hi)[4], uint32_t& plo, uint32_t& phi) {
  constexpr int TB = CB + 1;
  int32_t l0[CC], l1[CC], h0[CC], h1[CC];
  int32_t el0 = 0, el1 = 0, eh0 = 0, eh1 = 0;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    xq_pair<TB>(lo[c], l0[c], l1[c]);
    xq_pair<TB>(hi[c], h0[c], h1[c]);
    const int32_t a0 = scaled_half<TB>(l0[c], 0) - lo[c], a1 = scaled_half<TB>(l1[c], 1) - lo[c];
    const int32_t b0 = scaled_half<TB>(h0[c], 0) - hi[c], b1 = scaled_half<TB>(h1[c], 1) - hi[c];
    el0 += a0 * a0;
    el1 += a1 * a1;
    eh0 += b0 * b0;
    eh1 += b1 * b1;
  }
  plo = el1 < el0 ? 1u : 0u;
  phi = eh1 < eh0 ? 1u : 0u;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    lo[c] = plo ? l1[c] : l0[c];
    hi[c] = phi ? h1[c] : h0[c];
  }
}

// Shared p-bit: the reference's IEEE-f32 error, sum over channels of
// (fl(s_lo/255) - fl(lo/255))^2 + (fl(s_hi/255) - fl(hi/255))^2, every
// operation rounded on its own and folded left in channel order.
template <int CC, int CB>
UB_FN void shared_pbit(int32_t (&lo)[4], int32_t (&hi)[4], uint32_t& sb) {
  constexpr int TB = CB + 1;
  int32_t l0[CC], l1[CC], h0[CC], h1[CC];
  float err[2];
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    xq_pair<TB>(lo[c], l0[c], l1[c]);
    xq_pair<TB>(hi[c], h0[c], h1[c]);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const float bl = fsub_rn(fl_div255(scaled_half<TB>(p ? l1[c] : l0[c], p)), fl_div255(lo[c]));
      const float bh = fsub_rn(fl_div255(scaled_half<TB>(p ? h1[c] : h0[c], p)), fl_div255(hi[c]));
      const float term = fadd_rn(fmul_rn(bl, bl), fmul_rn(bh, bh));
      acc = c == 0 ? term : fadd_rn(acc, term);
    }
    err[p] = acc;
  }
  sb = err[1] < err[0] ? 1u : 0u;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    lo[c] = sb ? l1[c] : l0[c];
    hi[c] = sb ? h1[c] : h0[c];
  }
}

// (e*mask + 127) / 255 for an NB-bit endpoint as one mul-add-shift
template <int NB>
UB_FN int32_t scale_ep(int32_t e) {
  if constexpr (NB == 8) {
    return e;
  } else {
    constexpr int K = NB == 4 ? 962 : NB == 5 ? 1992 : NB == 6 ? 4048 : 8160;
    return (e * K + 8156) >> 14;
  }
}

// ---- mode 8 (void extent) -> BC7 mode 5 or 6 (bc7.rs:18-58, 312-375) -----

UB_FN void mode8_to_bc7(const uint32_t (&l)[4], uint32_t (&o)[4]) {
  int32_t c[4];
  int err0 = 0, err1 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = mode8_channel(l, k);
    err0 += c[k] == 255;  // mode 6 error at p = 0: only extremes are lossy
    err1 += c[k] == 0;    // ... at p = 1
  }
  if (err0 > 0 && err1 > 0) {
    // mode 5: 6 mode bits, 2 rotation, 3x7x2 colour, 8x2 alpha, weights 1
    put(o, 1u << 5, 0, 6);
    int ofs = 8;
#pragma unroll
    for (int k = 0; k < 3; ++k, ofs += 14) put(o, UB_LDG(&BC7_MODE_5_OPTIMAL_PACKED[c[k]]), ofs, 14);
    put(o, static_cast<uint32_t>(c[3]) * 0x101u, ofs, 16);
    ofs += 16;
    put(o, 1u, ofs, 1);
    ofs += 1;
#pragma unroll
    for (int i = 0; i < 15; ++i, ofs += 2) put(o, 1u, ofs, 2);
  } else {
    // mode 6: 7 mode bits, 4x7x2 endpoints, 2 p-bits, weights 5
    const int best_p = err1 < err0 ? 1 : 0;
    put(o, 1u << 6, 0, 7);
    int ofs = 7;
#pragma unroll
    for (int k = 0; k < 4; ++k, ofs += 14)
      put(o, UB_LDG(&BC7_MODE_6_OPTIMAL_PACKED[c[k] + 1 - best_p]), ofs, 14);
    put(o, static_cast<uint32_t>(best_p * 3), ofs, 2);
    ofs += 2;
    put(o, 5u, ofs, 3);
    ofs += 3;
#pragma unroll
    for (int i = 0; i < 15; ++i, ofs += 4) put(o, 5u, ofs, 4);
  }
}

// ---- the BC7 weight field as one word ------------------------------------
//
// Where the BC7 weight width equals the UASTC one and the mode has one plane
// (modes 0-4, 7, 9, 10, 15, 16), the BC7 weight field is the weight stream
// S (weight_stream in uastc_decode.cuh: weight k at [k*wb, (k+1)*wb), a zero
// bit put back above each UASTC anchor) with two edits, in one word:
//   - the fields of each BC7 subset j >= 1 whose anchor weight's MSB is set
//     are XORed with all ones (bc7.rs:171-195).  That MSB is S's bit
//     wb*a_j + wb - 1, a_j the subset's BC7 anchor texel; where a_j is also a
//     UASTC anchor S holds its zero bit there, so the subset never inverts;
//   - the MSB of texel 0 and of each BC7 anchor, now 0, is dropped again,
//     the highest first: BC7 stores an anchor's weight one bit short.
// The field then goes out in one put at its compile-time offset.  The other
// modes (remapped weights, two planes) put texel by texel.

template <int M>
constexpr bool kWordWeights = M != 8 && Mode<M>::planes == 1 &&
                              Mode<M>::weight_bits == Bc7Mode<Mode<M>::bc7>::weight_bits;

// The BC7 weight field of word-weights mode M (16*wb - subsets bits) and the
// invert flag of each BC7 subset (inv[0] is always false).  pat: the clamped
// pattern.
template <int M>
UB_FN uint64_t bc7_weight_word(const uint32_t (&l)[4], int32_t pat, bool (&inv)[3]) {
  using C = Mode<M>;
  using B = Bc7Mode<C::bc7>;
  static_assert(kWordWeights<M>, "the BC7 weight field is one word only where the widths match");
  constexpr int wb = C::weight_bits, nsub7 = B::subset_count, F = 16 * wb;
  inv[0] = inv[1] = inv[2] = false;
  if constexpr (nsub7 == 1) {
    // texel 0 is the only anchor of both formats: the UASTC field as it is
    return extract64(l, C::ofs_weights, F - 1);
  } else {
    using T = typename std::conditional<(F <= 32), uint32_t, uint64_t>::type;
    const int row = Family<C::fam>::base + pat;
    uint32_t st[4];
    weight_stream<M>(l, pat, st);
    T s = st[0];
    if constexpr (F > 32) s |= static_cast<T>(st[1]) << 32;

    // BC7 subsets j >= 1: the invert flag from the anchor's MSB, then the
    // inverted subsets' fields XORed with all ones
    const uint32_t ap = UB_LDG(&FAM_BC7_ANCHORS_PACKED[row]);  // anchor texel of subset j: nibble j
    const uint32_t sp = UB_LDG(&FAM_BC7_PAT_PACKED[row]);      // texel -> BC7 subset, 2 bits a texel
    const uint32_t a1 = (ap >> 4) & 15u, a2 = (ap >> 8) & 15u;
    constexpr uint32_t kLanes = 0x55555555u;
    inv[1] = ((s >> (wb * a1 + wb - 1)) & 1u) != 0u;
    uint32_t lanes = inv[1] ? sp & kLanes : 0u;
    if constexpr (nsub7 == 3) {
      inv[2] = ((s >> (wb * a2 + wb - 1)) & 1u) != 0u;
      lanes |= inv[2] ? (sp >> 1) & kLanes : 0u;
    }
    if constexpr (wb == 2) {
      s ^= lanes * 3u;
    } else {
      static_assert(wb == 3, "multi-subset weights are 2 or 3 bits");
      s ^= spread_lanes3(lanes);
    }

    // drop the anchors' zero MSBs, the highest texel first; texel 0 last
    if constexpr (nsub7 == 3) {
      const uint32_t hi = a1 > a2 ? a1 : a2, lo = a1 + a2 - hi;
      s = remove_zero(s, wb * hi + wb - 1);
      s = remove_zero(s, wb * lo + wb - 1);
    } else {
      s = remove_zero(s, wb * a1 + wb - 1);
    }
    return remove_zero(s, wb - 1);
  }
}

// ---- the block transcode --------------------------------------------------

// UASTC block (4 words) -> BC7 block (4 words).  Returns the block's error
// flag: an out-of-range pattern index (the output is still written, from
// the clamped pattern, exactly as the reference kernels do).
template <int M>
UB_FN bool uastc_to_bc7(const uint32_t (&l)[4], uint32_t (&o)[4]) {
  o[0] = o[1] = o[2] = o[3] = 0u;
  if constexpr (M == 8) {
    mode8_to_bc7(l, o);
    return false;
  } else {
    using C = Mode<M>;
    using B = Bc7Mode<C::bc7>;
    constexpr int planes = C::planes, nsub = C::subsets;
    constexpr int cc = B::channels, wb7 = B::weight_bits, nsub7 = B::subset_count;

    [[maybe_unused]] const int32_t cs = decode_compsel<M>(l);
    int32_t pat;
    const bool err = decode_pattern<M>(l, pat);

    int32_t ep[C::endpoint_count];
    decode_endpoints<M>(l, ep);
    int32_t pr[nsub][2][4];  // [subset][lo/hi][rgba]
    endpoint_pairs<M>(ep, pr);

    put(o, 1u << C::bc7, 0, C::bc7 + 1);
    int ofs = C::bc7 + 1;
    int32_t lo[nsub7][4], hi[nsub7][4];
    [[maybe_unused]] uint64_t wfield = 0;  // the weight field of the multi-subset modes
    [[maybe_unused]] bool inv[3];

    if constexpr (nsub7 != 1) {
      static_assert(kWordWeights<M>, "every multi-subset mode writes its weights as one word");
      using F = Family<C::fam>;
      const int row = F::base + pat;
      const uint32_t perm = UB_LDG(&FAM_PERM_PACKED[row]);
      put(o, UB_LDG(&FAM_BC7_INDEX[row]), ofs, B::pat_bits);
      ofs += B::pat_bits;

      // BC7 subset j takes UASTC subset perm[j] (bc7.rs:163-169)
#pragma unroll
      for (int j = 0; j < nsub7; ++j) {
        const uint32_t pj = (perm >> (4 * j)) & 15u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int32_t vl = pr[0][0][c], vh = pr[0][1][c];
#pragma unroll
          for (int s = 1; s < nsub; ++s) {
            vl = pj == static_cast<uint32_t>(s) ? pr[s][0][c] : vl;
            vh = pj == static_cast<uint32_t>(s) ? pr[s][1][c] : vh;
          }
          lo[j][c] = vl;
          hi[j][c] = vh;
        }
      }

      // Swap the endpoints of BC7 subset j >= 1 where its anchor weight's
      // MSB is set (bc7.rs:171-195); the weight field comes inverted
      wfield = bc7_weight_word<M>(l, pat, inv);
#pragma unroll
      for (int s = 1; s < nsub7; ++s) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int32_t a = lo[s][c], b = hi[s][c];
          lo[s][c] = inv[s] ? b : a;
          hi[s][c] = inv[s] ? a : b;
        }
      }
    } else {
      // single subset: the anchor is texel 0, stored with one bit less, so
      // the reference's anchor-MSB swap never fires
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[0][c] = pr[0][0][c];
        hi[0][c] = pr[0][1][c];
      }
      if constexpr (planes == 2) {
        // rotation: swap the selected channel with alpha (bc7.rs:216-219)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (cs == c) {
            const int32_t tl = lo[0][c], th = hi[0][c];
            lo[0][c] = lo[0][3];
            hi[0][c] = hi[0][3];
            lo[0][3] = tl;
            hi[0][3] = th;
          }
        }
        put(o, static_cast<uint32_t>(cs + 1) & 3u, ofs, 2);
        ofs += 2;
        if constexpr (B::id == 4) ofs += 1;  // index selection bit, always 0
      }
    }

    // p-bits or plain endpoint scaling (bc7.rs:249-274)
    uint32_t pb_lo[nsub7], pb_hi[nsub7];
#pragma unroll
    for (int j = 0; j < nsub7; ++j) {
      if constexpr (B::p_bits != 0) {
        unique_pbits<cc, B::color_bits>(lo[j], hi[j], pb_lo[j], pb_hi[j]);
      } else if constexpr (B::sp_bits != 0) {
        shared_pbit<cc, B::color_bits>(lo[j], hi[j], pb_lo[j]);
        pb_hi[j] = pb_lo[j];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lo[j][c] = scale_ep<B::color_bits>(lo[j][c]);
          hi[j][c] = scale_ep<B::color_bits>(hi[j][c]);
        }
        if constexpr (cc == 4) {
          lo[j][3] = scale_ep<B::alpha_bits>(lo[j][3]);
          hi[j][3] = scale_ep<B::alpha_bits>(hi[j][3]);
        }
      }
    }

    // endpoints (bc7.rs:276-286): lo and hi are adjacent fields
#pragma unroll
    for (int c = 0; c < cc; ++c) {
      constexpr int cb = B::color_bits, ab = B::alpha_bits;
      const int bits = c != 3 ? cb : ab;
#pragma unroll
      for (int j = 0; j < nsub7; ++j) {
        put(o, static_cast<uint32_t>(lo[j][c]) | (static_cast<uint32_t>(hi[j][c]) << bits), ofs,
            2 * bits);
        ofs += 2 * bits;
      }
    }
    if constexpr (B::p_bits != 0) {
#pragma unroll
      for (int j = 0; j < nsub7; ++j, ofs += 2) put(o, (pb_hi[j] << 1) | pb_lo[j], ofs, 2);
    } else if constexpr (B::sp_bits != 0) {
      put(o, (pb_lo[1] << 1) | pb_lo[0], ofs, 2);
      ofs += 2;
    }

    // weights (bc7.rs:296-307); anchors are written with one bit less
    if constexpr (kWordWeights<M>) {
      if constexpr (nsub7 == 1) wfield = bc7_weight_word<M>(l, pat, inv);
      put64(o, wfield, ofs, 16 * wb7 - nsub7);
    } else {
      // one subset, remapped weights or two planes: texel by texel, each
      // weight read where it is written, plane by plane
#pragma unroll
      for (int p = 0; p < planes; ++p) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int bits_i = i == 0 ? wb7 - 1 : wb7;
          put(o, remap_weight<C::weight_bits, wb7>(texel_weight<M>(l, 0u, i, p)), ofs, bits_i);
          ofs += bits_i;
        }
      }
    }
    return err;
  }
}

}  // namespace ub
