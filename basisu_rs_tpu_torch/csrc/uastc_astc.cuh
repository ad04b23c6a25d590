// K2 per-block logic: one UASTC 4x4 block -> one ASTC 4x4 block, specialised
// per UASTC mode (template <int M>).
//
// Port of basisu_rs_tpu/ops/astc.py (uastc_to_astc_mode, _mode8_to_astc),
// mirroring convert_block_from_uastc (reference:
// src/target_formats/astc.rs:8-181).  The shared decode is in
// uastc_decode.cuh; the plain PyTorch version is
// basisu_rs_tpu_torch/ops/astc.py.  Like uastc_decode.cuh, this source also
// compiles with g++ for the CPU tests.
#pragma once
#include "uastc_decode.cuh"

namespace ub {

// (bit offset, width) of member k's share of a packed ISE group: quints
// (0,3) (3,2) (5,2) of 7 bits, trits (0,2) (2,2) (4,1) (5,2) (7,1) of 8.
UB_FN constexpr int ise_slice_shift(bool quints, int k) {
  return quints ? (k == 0 ? 0 : k == 1 ? 3 : 5) : (k == 0 ? 0 : k == 1 ? 2 : k == 2 ? 4 : k == 3 ? 5 : 7);
}

UB_FN constexpr int ise_slice_width(bool quints, int k) {
  return quints ? (k == 0 ? 3 : 2) : (k == 2 || k == 4 ? 1 : 2);
}

// Void extent (astc.rs:17-43): the solid colour as four 16-bit channels.
UB_FN void mode8_to_astc(const uint32_t (&l)[4], uint32_t (&o)[4]) {
  put(o, 0xDFCu, 0, 12);
  put(o, 0xFFFFFu, 12, 20);
  put(o, 0xFFFFFFFFu, 32, 32);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t v = static_cast<uint32_t>(mode8_channel(l, c));
    put(o, (v << 8) | v, 64 + 16 * c, 16);
  }
}

// ---- ASTC weights ------------------------------------------------------------
//
// ASTC stores weight k bit-reversed at [128-(k+1)*wb, 128-k*wb), which is
// the 128-bit reversal of the weight stream S (weight_stream in
// uastc_decode.cuh: weight k at [k*wb, (k+1)*wb)): three BREVs of S's
// words fill the whole weight field.

// XOR every weight of a swapped subset in S with all ones.  The subset map
// (2 bits a texel) gives one bit a texel of each subset at bit 2i; with
// 2-bit weights that bit times 3 is the texel's field.
template <int M>
UB_FN void invert_stream(uint32_t (&s)[4], const bool (&inv)[Mode<M>::subsets], int32_t pat) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits, F = 16 * C::planes * wb;
  if constexpr (C::format == FORMAT_LA) {
    return;  // no blue contraction
  } else if constexpr (C::subsets == 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (32 * j < F) s[j] ^= inv[0] ? mask(imin(32, F - 32 * j)) : 0u;
  } else {
    const uint32_t sp = subsets_packed<M>(pat);
    constexpr uint32_t kLanes = 0x55555555u;
    uint32_t lanes = (inv[0] ? ~(sp | (sp >> 1)) & kLanes : 0u) | (inv[1] ? sp & kLanes : 0u);
    if constexpr (C::subsets == 3) lanes |= inv[2] ? (sp >> 1) & kLanes : 0u;
    if constexpr (wb == 2) {
      s[0] ^= lanes * 3u;
    } else {
      static_assert(wb == 3, "multi-subset weights are 2 or 3 bits");
      const uint64_t m = spread_lanes3(lanes);
      s[0] ^= static_cast<uint32_t>(m);
      s[1] ^= static_cast<uint32_t>(m >> 32);
    }
  }
}

// UASTC block (4 words) -> ASTC block (4 words).  Returns the block's error
// flag: an out-of-range pattern index (the output is still written, from the
// clamped pattern, as the reference kernels do).
template <int M>
UB_FN bool uastc_to_astc(const uint32_t (&l)[4], uint32_t (&o)[4]) {
  o[0] = o[1] = o[2] = o[3] = 0u;
  if constexpr (M == 8) {
    mode8_to_astc(l, o);
    return false;
  } else {
    using C = Mode<M>;
    using RG = BiseRange<C::range>;
    constexpr int E = C::endpoint_count, wb = C::weight_bits, planes = C::planes;
    constexpr int nsub = C::subsets, per_subset = E / nsub;

    [[maybe_unused]] const int32_t cs = decode_compsel<M>(l);
    int32_t pat;
    const bool err = decode_pattern<M>(l, pat);
    int32_t tq[E], bits[E];
    decode_endpoint_digits<M>(l, tq, bits);

    // Blue-contraction avoidance (astc.rs:55-78): where a subset's
    // unquantized lo endpoints of r, g, b sum above its hi ones, swap every
    // quantized (tq, bits) pair of the subset and invert its weights.
    bool inv[nsub];
#pragma unroll
    for (int s = 0; s < nsub; ++s) {
      inv[s] = false;
      if constexpr (C::format != FORMAT_LA) {
        const int b = s * per_subset;
        int32_t u[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) u[k] = unquant_endpoint<C::range>(tq[b + k], bits[b + k]);
        inv[s] = u[0] + u[2] + u[4] > u[1] + u[3] + u[5];
#pragma unroll
        for (int k = b; k < b + per_subset; k += 2) {
          const int32_t t0 = tq[k], t1 = tq[k + 1], b0 = bits[k], b1 = bits[k + 1];
          tq[k] = inv[s] ? t1 : t0;
          tq[k + 1] = inv[s] ? t0 : t1;
          bits[k] = inv[s] ? b1 : b0;
          bits[k + 1] = inv[s] ? b0 : b1;
        }
      }
    }

    // header (astc.rs:80-96): block mode, partition index, CEM
    put(o, static_cast<uint32_t>(C::astc_block_mode), 0, 13);
    int ofs = 13;
    if constexpr (C::fam != FAM_NONE && C::id != 1) {
      put(o, UB_LDG(&FAM_ASTC_INDEX10[Family<C::fam>::base + pat]), ofs, 10);
      ofs += 10 + 2;  // +2 zero bits: all endpoints share one CEM
    }
    constexpr uint32_t cem = C::format == FORMAT_RGB ? 8u : C::format == FORMAT_RGBA ? 12u : 4u;
    put(o, cem, ofs, 4);
    ofs += 4;

    // endpoints in ASTC integer sequence encoding (astc.rs:98-141)
    if constexpr (RG::trits || RG::quints) {
      constexpr bool quints = RG::quints != 0;
      constexpr int base = quints ? 5 : 3, per = quints ? 3 : 5;
#pragma unroll
      for (int chunk = 0; chunk < E; chunk += per) {
        const int members = E - chunk < per ? E - chunk : per;
        int32_t id = 0;
#pragma unroll
        for (int k = per - 1; k >= 0; --k) {
          if (k < members) id = id * base + tq[chunk + k];
        }
        const uint32_t packed = quints ? UB_LDG(&ASTC_QUINT_ENCODE[id]) : UB_LDG(&ASTC_TRIT_ENCODE[id]);
#pragma unroll
        for (int k = 0; k < per; ++k) {
          uint32_t v = 0u;  // padding members write zero bits
          if (k < members) v = static_cast<uint32_t>(bits[chunk + k]);
          put(o, v, ofs, RG::bits);
          ofs += RG::bits;
          put(o, packed >> ise_slice_shift(quints, k), ofs, ise_slice_width(quints, k));
          ofs += ise_slice_width(quints, k);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k, ofs += RG::bits) put(o, static_cast<uint32_t>(bits[k]), ofs, RG::bits);
    }

    // weights (astc.rs:143-178): the bit reversal of the stream, XOR-inverted
    // where a subset was swapped, fills [128 - 16 * planes * wb, 128)
    uint32_t st[4];
    weight_stream<M>(l, pat, st);
    invert_stream<M>(st, inv, pat);
    o[3] |= brev(st[0]);
    o[2] |= brev(st[1]);
    o[1] |= brev(st[2]);
    if constexpr (planes != 1) {
      put(o, static_cast<uint32_t>(cs), 128 - 16 * planes * wb - 2, 2);  // CCS, not reversed
    }
    return err;
  }
}

}  // namespace ub
