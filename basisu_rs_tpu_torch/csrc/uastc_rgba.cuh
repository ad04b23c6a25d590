// K3 per-block logic: one UASTC 4x4 block -> 16 packed RGBA texels,
// specialised per UASTC mode (template <int M>).
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

// UASTC block (4 words) -> 16 texel words in raster order within the block.
// Returns the block's error flag: an out-of-range pattern index (the texels
// are still written, from the clamped pattern, as the reference kernels do).
template <int M>
UB_FN bool uastc_to_rgba(const uint32_t (&l)[4], uint32_t (&o)[16]) {
  if constexpr (M == 8) {
    const uint32_t px = pack_rgba(mode8_channel(l, 0), mode8_channel(l, 1), mode8_channel(l, 2),
                                  mode8_channel(l, 3));
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = px;
    return false;
  } else {
    using C = Mode<M>;
    constexpr int planes = C::planes, nsub = C::subsets, wb = C::weight_bits;

    [[maybe_unused]] const int32_t cs = decode_compsel<M>(l);
    int32_t pat;
    const bool err = decode_pattern<M>(l, pat);
    int32_t ep[C::endpoint_count];
    decode_endpoints<M>(l, ep);
    uint32_t w[16 * planes];
    decode_weights<M>(l, pat, w);
    int32_t pr[nsub][2][4];
    endpoint_pairs<M>(ep, pr);

    // the per-block halves of the factored lerp, per subset and channel
    int32_t L0[nsub][4], D[nsub][4];
#pragma unroll
    for (int s = 0; s < nsub; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) interp_hoist(pr[s][0][c], pr[s][1][c], L0[s][c], D[s][c]);
    }
    const uint32_t sp = subsets_packed<M>(pat);

#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int32_t s_i = static_cast<int32_t>((sp >> (2 * i)) & 3u);
      int32_t ch[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (C::format == FORMAT_RGB && c == 3) {
          ch[3] = 255;  // RGB alpha: equal endpoints, the lerp is the identity
          continue;
        }
        // dual plane: the compsel channel reads plane 1
        uint32_t wr;
        if constexpr (planes == 1) wr = w[i];
        else wr = cs == c ? w[2 * i + 1] : w[2 * i];
        int32_t l0 = L0[0][c], d = D[0][c];
#pragma unroll
        for (int s = 1; s < nsub; ++s) {
          l0 = s_i == s ? L0[s][c] : l0;
          d = s_i == s ? D[s][c] : d;
        }
        ch[c] = interp_eval(l0, d, unquant_weight<wb>(static_cast<int32_t>(wr)));
      }
      o[i] = pack_rgba(ch[0], ch[1], ch[2], ch[3]);
    }
    return err;
  }
}

}  // namespace ub
