// K3 per-block logic: one UASTC 4x4 block -> 16 packed RGBA texels,
// specialised per UASTC mode (template <int M>), and the texel decode that
// K4 and K5 (uastc_etc.cuh) stream their texels from.
//
// Port of basisu_rs_tpu/ops/rgba.py (uastc_to_rgba_channels, pack_rgba),
// mirroring decode_block_to_rgba (reference: src/uastc.rs:237-327).  The
// shared decode is in uastc_decode.cuh; the plain PyTorch version is
// basisu_rs_tpu_torch/ops/rgba.py.  Like uastc_decode.cuh, this source also
// compiles with g++ for the CPU tests.
#pragma once
#include "uastc_decode.cuh"

namespace ub {

// Color32::to_rgba_u32 (src/color.rs:22-24): little-endian RGBA bytes.
UB_FN uint32_t pack_rgba(int32_t r, int32_t g, int32_t b, int32_t a) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) |
         (static_cast<uint32_t>(b) << 16) | (static_cast<uint32_t>(a) << 24);
}

// The per-block half of a non-mode-8 block's texel decode: the factored
// lerp (L0, D) of every subset and channel, the texel -> subset map, the
// weight-anchor word and the component selector.
template <int M>
struct BlockLerp {
  int32_t L0[Mode<M>::subsets][4], D[Mode<M>::subsets][4];
  uint32_t sp, abp;
  int32_t cs;
};

// Decode a non-mode-8 block into b, the lerp of channels 0..NC-1 (NC = 3
// leaves alpha unset).  Returns the block's error flag: an out-of-range
// pattern index (the texels still come from the clamped pattern, as in the
// reference kernels).
template <int M, int NC>
UB_FN bool decode_block(const uint32_t (&l)[4], BlockLerp<M>& b) {
  using C = Mode<M>;
  static_assert(M != 8, "mode 8 has no lerp");
  b.cs = decode_compsel<M>(l);
  int32_t pat;
  const bool err = decode_pattern<M>(l, pat);
  int32_t ep[C::endpoint_count];
  decode_endpoints<M>(l, ep);
  int32_t pr[C::subsets][2][4];
  endpoint_pairs<M>(ep, pr);
#pragma unroll
  for (int s = 0; s < C::subsets; ++s) {
#pragma unroll
    for (int c = 0; c < NC; ++c) interp_hoist(pr[s][0][c], pr[s][1][c], b.L0[s][c], b.D[s][c]);
  }
  b.abp = weight_anchors<M>(pat);
  b.sp = subsets_packed<M>(pat);
  return err;
}

// Texel i's subset.
template <int M>
UB_FN int32_t texel_subset(const BlockLerp<M>& b, int i) {
  return static_cast<int32_t>((b.sp >> (2 * i)) & 3u);
}

// Texel i's channels 0..NC-1 into ch.  Its weights are read from the
// block's words here, where they are used, so a caller that visits the
// texels in turn keeps no 16 x planes array of weights live.
template <int M, int NC>
UB_FN void texel_channels(const uint32_t (&l)[4], const BlockLerp<M>& b, int i, int32_t (&ch)[4]) {
  using C = Mode<M>;
  constexpr int wb = C::weight_bits;
  const int32_t s_i = texel_subset<M>(b, i);
  const int32_t u0 = unquant_weight<wb>(static_cast<int32_t>(texel_weight<M>(l, b.abp, i, 0)));
  int32_t u1 = u0;
  if constexpr (C::planes == 2) u1 = unquant_weight<wb>(static_cast<int32_t>(texel_weight<M>(l, b.abp, i, 1)));
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (C::format == FORMAT_RGB && c == 3) {
      ch[3] = 255;  // RGB alpha: equal endpoints, the lerp is the identity
      continue;
    }
    int32_t l0 = b.L0[0][c], d = b.D[0][c];
#pragma unroll
    for (int s = 1; s < C::subsets; ++s) {
      l0 = s_i == s ? b.L0[s][c] : l0;
      d = s_i == s ? b.D[s][c] : d;
    }
    ch[c] = interp_eval(l0, d, b.cs == c ? u1 : u0);  // dual plane: the compsel channel reads plane 1
  }
}

// Decode the block and call visit(i, ch) for each texel i = 0..15 in raster
// order within the block, ch[0..NC-1] holding its channels (r, g, b, a;
// NC = 3 skips alpha and leaves ch[3] unset).  Each texel's channels are
// computed just before its visit, so a caller that folds them into sums
// keeps no 16 x 4 array live.  Returns the block's error flag
// (decode_block).
template <int M, int NC, class Visit>
UB_FN bool for_each_texel(const uint32_t (&l)[4], Visit&& visit) {
  static_assert(NC == 3 || NC == 4, "3 or 4 channels");
  int32_t ch[4];
  if constexpr (M == 8) {
#pragma unroll
    for (int c = 0; c < NC; ++c) ch[c] = mode8_channel(l, c);
#pragma unroll
    for (int i = 0; i < 16; ++i) visit(i, ch);
    return false;
  } else {
    BlockLerp<M> b;
    const bool err = decode_block<M, NC>(l, b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      texel_channels<M, NC>(l, b, i, ch);
      visit(i, ch);
    }
    return err;
  }
}

// UASTC block (4 words) -> 16 texel words in raster order within the block.
template <int M>
UB_FN bool uastc_to_rgba(const uint32_t (&l)[4], uint32_t (&o)[16]) {
  return for_each_texel<M, 4>(l, [&](int i, const int32_t (&ch)[4]) { o[i] = pack_rgba(ch[0], ch[1], ch[2], ch[3]); });
}

}  // namespace ub
