// K3 on Hopper: UASTC 4x4 -> 16 packed RGBA8 texels, one hand-written CUDA
// kernel per UASTC mode (uastc_kernel<Rgba<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("rgba", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/rgba.py::uastc_to_rgba_mode.  The per-block logic is in
// uastc_rgba.cuh and uastc_decode.cuh, the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: bytes.  81 bytes of HBM a block (16 in, 64
// out, a 1-byte error flag; the dispatch's int64 index list adds 8 more),
// the most of the UASTC kernels: at 2^23 blocks the 81 bytes alone take
// 0.203 ms at 3.35 TB/s.  The arithmetic is 16 texels x up to 4 channels
// of one multiply-add-shift each after the shared decode, 158-921 SASS
// instructions a block.
//
// What the design does about it: one thread decodes each block, one
// 16-byte load, and the warp writes its 32 texel rows cooperatively (the
// 64-byte row path of uastc_launch.cuh): staged in shared memory, then
// eight whole rows a warp-wide store, so every store fills whole sectors.
// The lerp stays in its factored int32 form (L0 + D*w) >> 14, hoisted per
// subset and channel, and each texel's weights are read where they are
// used.  Measured with chip_smoke.py (H100 80GB HBM3, 700 W):
// the 19 launches of the 2^23-block all-mode cell take 0.382 ms against
// 0.663 ms with one thread writing its own row in four 16-byte stores 64
// bytes apart; at 2^23 contiguous blocks of one mode the light modes reach
// 85% of the HBM bound (2.85 TB/s), the 3-subset mode 3 61%.  With each
// mode's index randomly permuted the 19 launches take 0.55 ms.
#include "uastc_launch.cuh"
#include "uastc_rgba.cuh"

namespace {

template <int M>
struct Rgba {
  static constexpr int kOutBytes = 64;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[16]) { return ub::uastc_to_rgba<M>(l, o); }
};

}  // namespace

// Unpack the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 64-byte texel rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_rgba_launch(int mode, const void* in, const void* index, int n, void* out,
                                 void* err, void* stream) {
  return ub::launch<Rgba>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_rgba_warps(int mode, int* warps) { return ub::resident_warps<Rgba>(mode, warps); }
