// The UASTC block decode shared by the BC7 (K1), ASTC (K2) and RGBA (K3)
// kernels: bit-field access over the block's four words, the per-mode field
// decode (component selector, pattern, BISE endpoints, weights), and the
// pieces of the ASTC lerp.  Everything is specialised per UASTC mode
// (template <int M>), so every bit offset is a compile-time constant.
//
// Port of basisu_rs_tpu/ops/uastc_decode.py and the helpers of ops/bits.py;
// the plain PyTorch versions are basisu_rs_tpu_torch/ops/uastc_decode.py and
// ops/bits.py.
//
// The same source compiles two ways through the macro shim below:
//   - nvcc: device functions, tables in __device__ global memory read with
//     __ldg (pattern-indexed lookups diverge, which __constant__ serialises);
//   - g++:  host functions and static tables, so the CPU tests can hold this
//     exact code against the plain versions (tests/test_torch_csrc_host.py).
//
// Traps this code is written against:
//   - IEEE f32: fl_div255 and the shared p-bit error round every multiply
//     and add on its own (fmul_rn/fadd_rn/fsub_rn; nvcc --fmad=false, g++
//     -ffp-contract=off as a second guard).
//   - Shift counts >= 32 are undefined in C++: extract/put keep the
//     reference's `w + 1 < W` bounds, and no shift below can reach 32.
//   - Words are uint32_t and field arithmetic int32_t, with explicit casts,
//     so `>>` on a word is always logical.
#pragma once
#include <stdint.h>

#include <type_traits>

#if defined(__CUDACC__)
#define UB_FN __device__ __forceinline__
#define UB_TABLE static __device__ const
#define UB_LDG(p) __ldg(p)
#else
#define UB_FN inline
#define UB_TABLE static const
#define UB_LDG(p) (*(p))
#endif

#include "uastc_tables.cuh"

namespace ub {

// Threads a CTA of every UASTC kernel (uastc_launch.cuh); K4's key tables
// (uastc_etc.cuh) give each thread a column of that many entries a key.
constexpr int kThreads = 256;

// ---- IEEE-single arithmetic, one rounding per operation -------------------

UB_FN float fmul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

UB_FN float fadd_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

UB_FN float fsub_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// ---- integer intrinsics, each with its host form --------------------------

UB_FN uint32_t popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return static_cast<uint32_t>(__popc(x));
#else
  return static_cast<uint32_t>(__builtin_popcount(x));
#endif
}

// PRMT: byte k of the result is byte (s >> 4k) & 7 of the pair (b:a), a
// holding bytes 0-3 (selector nibbles with bit 3 set, sign replication,
// are not used here).
UB_FN uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(a, b, s);
#else
  const uint64_t x = (static_cast<uint64_t>(b) << 32) | a;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= static_cast<uint32_t>((x >> (8 * ((s >> (4 * k)) & 7u))) & 0xFFu) << (8 * k);
  return r;
#endif
}

// Lowest and highest set bit of x != 0.
UB_FN int32_t low_bit(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}

UB_FN int32_t high_bit(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz(static_cast<int>(x));
#else
  return 31 - __builtin_clz(x);
#endif
}

// BREV: bit i of x to bit 31 - i.
UB_FN uint32_t brev(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __brev(x);
#else
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
#endif
}

// SHF.L.W: the high word of (hi:lo) << (s & 31).
UB_FN uint32_t funnel_shl(uint32_t lo, uint32_t hi, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, s);
#else
  s &= 31u;
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

// fl(x/255) for x in 0..255 without a divide: y0 = x*257*2^-16 is exact,
// and fl(x/255) = fl(y0 + fl(y0*K)), K = fl(2^-16/(1-2^-16)).
UB_FN float fl_div255(int32_t x) {
  const float y0 = fmul_rn(static_cast<float>(x), 0x1.01p-8f);
  return fadd_rn(y0, fmul_rn(y0, 0x1.0001p-16f));
}

UB_FN constexpr int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
UB_FN constexpr int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// ---- bit fields over four little-endian 32-bit words ----------------------

UB_FN uint32_t mask(int count) {
  return count >= 32 ? 0xFFFFFFFFu : ((1u << count) - 1u);
}

// Static-offset extract; bits past the block read as zero.
UB_FN uint32_t extract(const uint32_t (&l)[4], int offset, int count) {
  if (count == 0) return 0u;
  const int w = offset >> 5, b = offset & 31;
  uint32_t val = (w < 4 ? l[w] : 0u) >> b;
  if (b + count > 32 && w + 1 < 4) val |= l[w + 1] << (32 - b);
  return val & mask(count);
}

// One dynamic bit whose word lies in the static bit range [lo_bit, hi_bit).
UB_FN uint32_t extract_bit_dyn(const uint32_t (&l)[4], uint32_t offset, int lo_bit,
                               int hi_bit) {
  const int wlo = lo_bit >> 5, whi = (hi_bit - 1) >> 5;
  const uint32_t w = offset >> 5;
  uint32_t v = l[wlo];
#pragma unroll
  for (int k = wlo + 1; k <= whi; ++k) v = (w == static_cast<uint32_t>(k)) ? l[k] : v;
  return (v >> (offset & 31u)) & 1u;
}

// OR a `count`-bit field into the output words; bits past the end drop.
UB_FN void put(uint32_t (&o)[4], uint32_t value, int offset, int count) {
  if (count == 0) return;
  value &= mask(count);
  const int w = offset >> 5, b = offset & 31;
  if (w < 4) o[w] |= value << b;
  if (b + count > 32 && w + 1 < 4) o[w + 1] |= value >> (32 - b);
}

// extract and put of a field of up to 64 bits at a static offset.
UB_FN uint64_t extract64(const uint32_t (&l)[4], int offset, int count) {
  uint64_t v = extract(l, offset, imin(32, count));
  if (count > 32) v |= static_cast<uint64_t>(extract(l, offset + 32, count - 32)) << 32;
  return v;
}

UB_FN void put64(uint32_t (&o)[4], uint64_t value, int offset, int count) {
  put(o, static_cast<uint32_t>(value), offset, imin(32, count));
  if (count > 32) put(o, static_cast<uint32_t>(value >> 32), offset + 32, count - 32);
}

// ---- UASTC field decode (ops/uastc_decode.py) -----------------------------

// Component selector: static 3 for LA dual plane, else the 2-bit field of
// dual-plane modes, else 0 (uastc.rs:343-350).
template <int M>
UB_FN int32_t decode_compsel(const uint32_t (&l)[4]) {
  using C = Mode<M>;
  if constexpr (C::planes == 2 && C::format == FORMAT_LA) return 3;
  else if constexpr (C::compsel_bits != 0) return static_cast<int32_t>(extract(l, C::ofs_compsel, 2));
  else return 0;
}

// Pattern index, clamped to the mode's pattern count; returns the error flag
// of an out-of-range index (uastc.rs:361-365).
template <int M>
UB_FN bool decode_pattern(const uint32_t (&l)[4], int32_t& pat) {
  using C = Mode<M>;
  pat = 0;
  if constexpr (C::pattern_bits != 0) {
    const int32_t p = static_cast<int32_t>(extract(l, C::ofs_pattern, C::pattern_bits));
    const bool err = p >= C::pattern_count;
    pat = err ? C::pattern_count - 1 : p;
    return err;
  } else {
    return false;
  }
}

template <int R>
UB_FN int32_t unquant_endpoint(int32_t tq, int32_t bits) {
  using RG = BiseRange<R>;
  if constexpr (RG::trits == 0 && RG::quints == 0) {
    if constexpr (RG::bits == 8) {
      return bits;
    } else {
      int32_t val = bits << (8 - RG::bits);
#pragma unroll
      for (int sh = 8 - 2 * RG::bits; sh > -RG::bits; sh -= RG::bits)
        val |= sh >= 0 ? bits << sh : bits >> -sh;
      return val;
    }
  } else {
    return UB_LDG(&UNQUANT_LUT[RG::unquant_base + ((tq << RG::bits) | bits)]);
  }
}

// The quantized endpoints: per endpoint its trit/quint digit (0 for
// pure-bit ranges) and its raw bits.
template <int M>
UB_FN void decode_endpoint_digits(const uint32_t (&l)[4], int32_t (&tq)[Mode<M>::endpoint_count],
                                  int32_t (&bits)[Mode<M>::endpoint_count]) {
  using C = Mode<M>;
  using RG = BiseRange<C::range>;
  constexpr int E = C::endpoint_count;
  int ofs = C::ofs_endpoints;
  if constexpr (RG::trits || RG::quints) {
    // groups of 3 quints in 7 bits or 5 trits in 8 bits, digits split off
    // by mul-shift division: floor(g/5) = (g*205)>>10, floor(g/3) = (g*171)>>9
    constexpr int base = RG::quints ? 5 : 3, per = RG::quints ? 3 : 5;
    constexpr int gw = RG::quints ? 7 : 8;
    constexpr int mul = RG::quints ? 205 : 171, sh = RG::quints ? 10 : 9;
    int k = 0;
#pragma unroll
    for (int g = 0; g < (E + per - 1) / per; ++g) {
      const int members = (E - g * per) < per ? (E - g * per) : per;
      // partial group widths: quints {1: 3, 2: 5}, trits {1: 2, 2: 4, 3: 5, 4: 7}
      const int width = members == per ? gw
                        : RG::quints   ? (members == 1 ? 3 : 5)
                                       : (members == 1 ? 2 : members == 2 ? 4 : members == 3 ? 5 : 7);
      int32_t v = static_cast<int32_t>(extract(l, ofs, width));
      ofs += width;
#pragma unroll
      for (int m = 0; m < per; ++m) {
        if (m < members) {
          if (m == members - 1) {
            tq[k++] = v - base * (v >= base ? 1 : 0);
          } else {
            const int32_t q = (v * mul) >> sh;
            tq[k++] = v - q * base;
            v = q;
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) tq[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) bits[i] = static_cast<int32_t>(extract(l, ofs + i * RG::bits, RG::bits));
}

// The unquantized endpoints, 0..255.
template <int M>
UB_FN void decode_endpoints(const uint32_t (&l)[4], int32_t (&ep)[Mode<M>::endpoint_count]) {
  constexpr int E = Mode<M>::endpoint_count;
  int32_t tq[E], bits[E];
  decode_endpoint_digits<M>(l, tq, bits);
#pragma unroll
  for (int i = 0; i < E; ++i) ep[i] = unquant_endpoint<Mode<M>::range>(tq[i], bits[i]);
}

// The pattern's packed anchors-before counts (2 bits a texel) that
// texel_weight reads in the multi-subset modes; 0 in the others.
template <int M>
UB_FN uint32_t weight_anchors(int32_t pat) {
  using C = Mode<M>;
  if constexpr (C::multi) return UB_LDG(&FAM_ANCHORS_BEFORE_PACKED[Family<C::fam>::base + pat]);
  else return 0u;
}

// Texel i's raw quantized weight of plane p (i, p compile-time after
// unrolling); anchor texels are stored with one less bit.  abp:
// weight_anchors<M>(pat).  A caller that reads each weight where it uses it
// keeps no array of 16 x planes weights live.
template <int M>
UB_FN uint32_t texel_weight(const uint32_t (&l)[4], uint32_t abp, int i, int p) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits, planes = C::planes, base = C::ofs_weights;
  if constexpr (!C::multi) {
    // texel 0, the only anchor, has planes fields of wb - 1 bits
    return i == 0 ? extract(l, base + p * (wb - 1), wb - 1)
                  : extract(l, base + planes * (wb - 1) + planes * wb * (i - 1) + p * wb, wb);
  } else {
    // Multi-subset modes are single-plane.  Texel i's bits lie in the static
    // window [base + wb*i - maxab_i, base + wb*i + wb), where ab_i is the
    // pattern's count of anchors before texel i: one static extract and a
    // small variable shift by (maxab_i - ab_i).
    static_assert(planes == 1, "multi-subset modes are single-plane");
    using F = Family<C::fam>;
    const int lo = (F::ab_min_packed >> (2 * i)) & 3, hi = (F::ab_max_packed >> (2 * i)) & 3;
    const uint32_t ab = lo == hi ? static_cast<uint32_t>(lo) : (abp >> (2 * i)) & 3u;
    uint32_t ab_next = F::n_anchors;
    if (i < 15) {
      const int lo2 = (F::ab_min_packed >> (2 * i + 2)) & 3;
      const int hi2 = (F::ab_max_packed >> (2 * i + 2)) & 3;
      ab_next = lo2 == hi2 ? static_cast<uint32_t>(lo2) : (abp >> (2 * i + 2)) & 3u;
    }
    const uint32_t wmask = mask(wb) >> (ab_next - ab);  // anchor: one bit less
    const uint32_t raw = lo == hi ? extract(l, base + wb * i - lo, wb)
                                  : extract(l, base + wb * i - hi, wb + hi) >> (hi - ab);
    return raw & wmask;
  }
}

// Raw quantized weights in decode order (k = planes*i + plane).
template <int M>
UB_FN void decode_weights(const uint32_t (&l)[4], int32_t pat,
                          uint32_t (&w)[16 * Mode<M>::planes]) {
  constexpr int planes = Mode<M>::planes;
  const uint32_t abp = weight_anchors<M>(pat);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int p = 0; p < planes; ++p) w[planes * i + p] = texel_weight<M>(l, abp, i, p);
  }
}

// ---- the weight stream --------------------------------------------------------
//
// The stream S holds weight k (decode order, k = planes*i + plane) at
// [k*wb, (k+1)*wb): the UASTC weight field with a zero bit put back above
// each anchor's field, since UASTC stores an anchor's weight one bit
// short.  K2 writes its bit reversal as the ASTC weight field; K4 reads
// each texel's weights from it at compile-time offsets.

// S += its bits from p up: a zero bit at p, the bits from p moved up one.
template <class T>
UB_FN T insert_zero(T s, uint32_t p) {
  return s + (s & (~T(0) << p));
}

// The inverse of insert_zero where bit p of S is 0: the bit dropped and the
// bits above it moved down one, (S & mask(p)) | ((S >> 1) & ~mask(p)).
template <class T>
UB_FN T remove_zero(T s, uint32_t p) {
  return s - ((s >> 1) & (~T(0) << p));
}

// One bit a texel (bit 2i: texel i) moved into all 3 bits of field i of a
// stream of 3-bit weights (bits [3i, 3i + 3)): lane i moves up by i, in
// steps of 8, 4, 2 and 1.  With 2-bit weights that bit times 3 is the
// field.  K1 and K2 XOR the fields of a swapped subset with these masks.
UB_FN constexpr uint64_t lane_step_mask(int sh) {
  uint64_t m = 0;
  for (int i = 0; i < 16; ++i)
    if (i & sh) m |= 1ull << (2 * i + (i & ~(2 * sh - 1)));
  return m;
}

UB_FN uint64_t spread_lanes3(uint32_t lanes) {
  uint64_t x = lanes;
  constexpr uint64_t m8 = lane_step_mask(8), m4 = lane_step_mask(4), m2 = lane_step_mask(2), m1 = lane_step_mask(1);
  x = (x & ~m8) | ((x & m8) << 8);
  x = (x & ~m4) | ((x & m4) << 4);
  x = (x & ~m2) | ((x & m2) << 2);
  x = (x & ~m1) | ((x & m1) << 1);
  return x * 7u;
}

// Mode M's weight stream S in words s[0..2] (at most 80 bits; bits past
// 16 * planes * wb and s[3] are 0, so extract() reads it as a block).
// pat: the clamped pattern.
template <int M>
UB_FN void weight_stream(const uint32_t (&l)[4], int32_t pat, uint32_t (&s)[4]) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits, planes = C::planes, base = C::ofs_weights, F = 16 * planes * wb;
  s[3] = 0u;
  if constexpr (!C::multi) {
    // texel 0 is the only anchor, its planes fields first: S bits from
    // planes * wb up are the UASTC bits from base - planes up
#pragma unroll
    for (int j = 0; j < 3; ++j) s[j] = 32 * j < F ? extract(l, base - planes + 32 * j, imin(32, F - 32 * j)) : 0u;
    uint32_t lo = extract(l, base, wb - 1);
    if constexpr (planes == 2) lo |= extract(l, base + wb - 1, wb - 1) << wb;
    s[0] = (s[0] & ~mask(planes * wb)) | lo;
  } else {
    // single-plane, F <= 48: texel 0 is an anchor, and the pattern's other
    // anchors (one or two) come in ascending order
    static_assert(planes == 1 && F <= 64, "multi-subset modes are single-plane");
    using T = typename std::conditional<(F <= 32), uint32_t, uint64_t>::type;
    using Fam = Family<C::fam>;
    constexpr int n = F - Fam::n_anchors;  // the UASTC field's bits
    T v = extract(l, base, imin(32, n));
    if constexpr (n > 32) v |= static_cast<T>(extract(l, base + 32, n - 32)) << 32;
    v = insert_zero(v, wb - 1);
    const uint32_t ap = UB_LDG(&FAM_ANCHORS_PACKED[Fam::base + pat]);  // anchor texel of subset k: nibble k
    if constexpr (Fam::n_anchors == 2) {
      const uint32_t a = (ap | (ap >> 4)) & 15u;  // one nibble is texel 0
      v = insert_zero(v, wb * a + wb - 1);
    } else {
      static_assert(Fam::n_anchors == 3, "two or three subsets");
      const uint32_t a0 = ap & 15u, a1 = (ap >> 4) & 15u, a2 = (ap >> 8) & 15u;
      const uint32_t hi = a0 > a1 ? (a0 > a2 ? a0 : a2) : (a1 > a2 ? a1 : a2);
      const uint32_t lo = a0 + a1 + a2 - hi;  // one of the three is texel 0
      v = insert_zero(v, wb * lo + wb - 1);
      v = insert_zero(v, wb * hi + wb - 1);
    }
    s[0] = static_cast<uint32_t>(v);
    s[1] = F > 32 ? static_cast<uint32_t>(static_cast<uint64_t>(v) >> 32) : 0u;
    s[2] = 0u;
  }
}

// Endpoint pairs [subset][lo/hi][rgba] (uastc.rs:176-216): RGB alpha is
// 255, LA replicates L into r, g and b.
template <int M>
UB_FN void endpoint_pairs(const int32_t (&ep)[Mode<M>::endpoint_count],
                          int32_t (&pr)[Mode<M>::subsets][2][4]) {
  using C = Mode<M>;
#pragma unroll
  for (int s = 0; s < C::subsets; ++s) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (C::format == FORMAT_RGB) {
        pr[s][k][0] = ep[6 * s + k];
        pr[s][k][1] = ep[6 * s + 2 + k];
        pr[s][k][2] = ep[6 * s + 4 + k];
        pr[s][k][3] = 255;
      } else if constexpr (C::format == FORMAT_RGBA) {
#pragma unroll
        for (int c = 0; c < 4; ++c) pr[s][k][c] = ep[8 * s + 2 * c + k];
      } else {
        pr[s][k][0] = pr[s][k][1] = pr[s][k][2] = ep[4 * s + k];
        pr[s][k][3] = ep[4 * s + 2 + k];
      }
    }
  }
}

// texel -> UASTC subset map of the block's pattern, 2 bits a texel (0 for
// single-subset modes, mode 1 included: its family serves BC7 only).
template <int M>
UB_FN uint32_t subsets_packed(int32_t pat) {
  using C = Mode<M>;
  if constexpr (C::fam == FAM_NONE || C::id == 1) {
    return 0u;
  } else {
    return UB_LDG(&FAM_PAT_PACKED[Family<C::fam>::base + pat]);
  }
}

// Quantized weight -> 0..64, closed forms of the reference LUTs
// (uastc.rs:697-719).
template <int WB>
UB_FN int32_t unquant_weight(int32_t w) {
  if constexpr (WB == 1) return w * 64;
  else if constexpr (WB == 2) return 21 * w + (w >= 2 ? 1 : 0);
  else if constexpr (WB == 3) return 9 * w + (w >= 4 ? 1 : 0);
  else if constexpr (WB == 4) return 4 * w + (w >> 2) + (w >> 3);  // q + (q>>1), q = w>>2
  else {
    static_assert(WB == 5, "no such weight width");
    return 2 * w + (w >= 16 ? 2 : 0);
  }
}

// The factored ASTC lerp ((l*257)*(64-w) + (h*257)*w + 32) >> 14
// (uastc.rs:218-235) as a per-block half, L0 = 257*64*l + 32 and
// D = 257*(h-l), and a per-texel half (L0 + D*w) >> 14.  The sum lies in
// [32, 4194272], so int32 holds it and the shift is a floor.
UB_FN void interp_hoist(int32_t lo, int32_t hi, int32_t& L0, int32_t& D) {
  const int32_t d = hi - lo;
  L0 = (lo << 14) + (lo << 6) + 32;
  D = (d << 8) + d;
}

UB_FN int32_t interp_eval(int32_t L0, int32_t D, int32_t w) { return (L0 + D * w) >> 14; }

// Void extent (mode 8): the solid colour's channel c (uastc.rs:387-394).
UB_FN int32_t mode8_channel(const uint32_t (&l)[4], int c) {
  return static_cast<int32_t>(extract(l, 5 + 8 * c, 8));
}

}  // namespace ub
