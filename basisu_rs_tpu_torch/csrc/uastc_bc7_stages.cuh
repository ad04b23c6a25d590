// T1 per-block logic: one stage of K1 for one UASTC mode, folded into a
// 32-bit XOR checksum a block (template <int M, int S>), built from K1's own
// device functions in uastc_decode.cuh and uastc_bc7.cuh.
//
// Port of the stage closures of tools/ablate_bc7.py:126-190 (the TPU tool
// that times them through build_stage_kernel, pl.pallas_call at :58).  The
// plain PyTorch version is basisu_rs_tpu_torch/ops/bc7_stages.py.  Like the
// other per-block sources, this one also compiles with g++ for the CPU tests.
//
// The stages (S), each the XOR of what it computes, as uint32:
//   0 full              K1's four output words and its err flag
//   1 decode_endpoints  the unquantized endpoints
//   2 decode_weights    the raw weights and the anchor texel indices
//   3 decode_fields     endpoints, weights, component selector and pattern
//   4 pbit              the unique-p-bit search (4 channels, 5 colour bits)
//                       on fake endpoints (bytes of words 0 and 1), once per
//                       UASTC subset: for 2-subset modes the same result is
//                       XORed twice, the checksum is 0 and the compiler drops
//                       the search, as XLA does on the TPU
//   5 permute_invert    decode_fields, then the tool's own permutation,
//                       anchor and invert arithmetic: the BC7 pattern index,
//                       each BC7 subset's permuted endpoints (hi where its
//                       anchor weight's bit 3 is set, else lo) and every
//                       weight remapped to 4 bits (~w & 15 in those subsets)
// Stages 2 and 3 do not trace for mode 8 (the void extent has no weights),
// so (8, 2) and (8, 3) are not instantiated.  Stage 5 exists for the seven
// modes with a pattern family (1, 2, 3, 4, 7, 9, 16): the closure reads the
// family's rows, which the other modes do not have.
#pragma once
#include "uastc_bc7.cuh"

namespace ub {

constexpr int BC7_STAGES = 6;
constexpr int STAGE_FULL = 0, STAGE_DECODE_ENDPOINTS = 1, STAGE_DECODE_WEIGHTS = 2, STAGE_DECODE_FIELDS = 3,
              STAGE_PBIT = 4, STAGE_PERMUTE_INVERT = 5;

// whether the JAX stage function of (M, S) traces
template <int M, int S>
constexpr bool kStageExists = S == STAGE_PERMUTE_INVERT
                                  ? Mode<M>::fam != FAM_NONE
                                  : !(M == 8 && (S == STAGE_DECODE_WEIGHTS || S == STAGE_DECODE_FIELDS));

template <int N>
UB_FN uint32_t xor_all(const int32_t (&v)[N]) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) acc ^= static_cast<uint32_t>(v[i]);
  return acc;
}

template <int N>
UB_FN uint32_t xor_all(const uint32_t (&v)[N]) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) acc ^= v[i];
  return acc;
}

// XOR of the anchor texel indices of the block's pattern (uastc_decode.py
// decode_anchors): texel 0 for single-subset modes, mode 1 included.
template <int M>
UB_FN uint32_t anchors_xor(int32_t pat) {
  using C = Mode<M>;
  if constexpr (C::fam == FAM_NONE || (C::subsets == 1 && C::id != 7)) {
    return 0u;
  } else {
    using F = Family<C::fam>;
    const uint32_t packed = UB_LDG(&FAM_ANCHORS_PACKED[F::base + pat]);
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < F::n_anchors; ++k) acc ^= (packed >> (4 * k)) & 15u;
    return acc;
  }
}

// Stage 5, tools/ablate_bc7.py:154-190.  This is the tool's arithmetic, not
// K1's invert step: nsub7 is the UASTC subset count, subset 0 is tested too
// (at texel 0), every weight is remapped to 4 bits, and the 16 weights are
// XORed one by one.  Every data-dependent index goes through a select chain
// whose default is element 0, as the tool's _dyn_select does.
template <int M>
UB_FN uint32_t permute_invert(const uint32_t (&l)[4]) {
  using C = Mode<M>;
  constexpr int nsub = C::subsets;
  int32_t pat;
  decode_pattern<M>(l, pat);
  int32_t ep[C::endpoint_count];
  decode_endpoints<M>(l, ep);
  int32_t pr[nsub][2][4];  // [subset][lo/hi][rgba]
  endpoint_pairs<M>(ep, pr);
  uint32_t w[16];
  decode_weights<M>(l, pat, w);
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = remap_weight<C::weight_bits, 4>(w[i]);

  const int row = Family<C::fam>::base + pat;
  const uint32_t sp = UB_LDG(&FAM_BC7_PAT_PACKED[row]);      // texel -> BC7 subset, 2 bits a texel
  const uint32_t ap = UB_LDG(&FAM_BC7_ANCHORS_PACKED[row]);  // anchor texel of subset s: nibble s
  const uint32_t perm = UB_LDG(&FAM_PERM_PACKED[row]);       // BC7 subset j <- UASTC subset nibble j
  uint32_t acc = UB_LDG(&FAM_BC7_INDEX[row]);

  bool inv[nsub];
#pragma unroll
  for (int s = 0; s < nsub; ++s) {
    const uint32_t a = s == 0 ? 0u : (ap >> (4 * s)) & 15u;
    uint32_t v = w[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) v = a == static_cast<uint32_t>(k) ? w[k] : v;
    inv[s] = ((v >> 3) & 1u) != 0u;
  }
#pragma unroll
  for (int j = 0; j < nsub; ++j) {
    const uint32_t pj = (perm >> (4 * j)) & 15u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int32_t vl = pr[0][0][c], vh = pr[0][1][c];
#pragma unroll
      for (int s = 1; s < nsub; ++s) {
        vl = pj == static_cast<uint32_t>(s) ? pr[s][0][c] : vl;
        vh = pj == static_cast<uint32_t>(s) ? pr[s][1][c] : vh;
      }
      acc ^= static_cast<uint32_t>(inv[j] ? vh : vl);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t sub = (sp >> (2 * i)) & 3u;
    bool inv_i = inv[0];
#pragma unroll
    for (int s = 1; s < nsub; ++s) inv_i = sub == static_cast<uint32_t>(s) ? inv[s] : inv_i;
    acc ^= inv_i ? ~w[i] & 15u : w[i];
  }
  return acc;
}

template <int M, int S>
UB_FN uint32_t bc7_stage(const uint32_t (&l)[4]) {
  using C = Mode<M>;
  static_assert(kStageExists<M, S>, "the JAX stage function does not trace for this mode");
  if constexpr (S == STAGE_FULL) {
    uint32_t o[4];
    const bool err = uastc_to_bc7<M>(l, o);
    return xor_all(o) ^ (err ? 1u : 0u);
  } else if constexpr (S == STAGE_DECODE_ENDPOINTS) {
    int32_t ep[C::endpoint_count];
    decode_endpoints<M>(l, ep);
    return xor_all(ep);
  } else if constexpr (S == STAGE_DECODE_WEIGHTS || S == STAGE_DECODE_FIELDS) {
    int32_t pat;
    decode_pattern<M>(l, pat);
    uint32_t w[16 * C::planes];
    decode_weights<M>(l, pat, w);
    if constexpr (S == STAGE_DECODE_WEIGHTS) {
      return xor_all(w) ^ anchors_xor<M>(pat);
    } else {
      int32_t ep[C::endpoint_count];
      decode_endpoints<M>(l, ep);
      return xor_all(ep) ^ xor_all(w) ^ static_cast<uint32_t>(decode_compsel<M>(l)) ^ static_cast<uint32_t>(pat);
    }
  } else if constexpr (S == STAGE_PERMUTE_INVERT) {
    return permute_invert<M>(l);
  } else {
    static_assert(S == STAGE_PBIT, "no such stage");
    uint32_t acc = 0u;
#pragma unroll
    for (int s = 0; s < C::subsets; ++s) {
      int32_t lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = static_cast<int32_t>(extract(l, 8 * c, 8));
        hi[c] = static_cast<int32_t>(extract(l, 32 + 8 * c, 8));
      }
      uint32_t p0, p1;
      unique_pbits<4, 5>(lo, hi, p0, p1);
      acc ^= xor_all(lo) ^ xor_all(hi) ^ p0 ^ p1;
    }
    return acc;
  }
}

}  // namespace ub
