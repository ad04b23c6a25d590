// K3 on Hopper: UASTC 4x4 -> 16 packed RGBA8 texels, one hand-written CUDA
// kernel per UASTC mode (uastc_kernel<Rgba<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("rgba", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/rgba.py::uastc_to_rgba_mode.  The per-block logic is in
// uastc_rgba.cuh and uastc_decode.cuh, the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: 81 bytes of HBM a block (16 in, 64 out, a
// 1-byte error flag; the dispatch's int64 index list adds 8 more), the most
// of the UASTC kernels: at 2^23 blocks the 81 bytes alone take 0.203 ms at
// 3.35 TB/s.  The arithmetic
// is 16 texels x up to 4 channels of one multiply-add-shift each, after
// the shared decode.
//
// What the design does about it: one thread per block, one 16-byte load and
// four 16-byte stores of its 64 texel bytes, in place through the index
// list, so every byte is moved once.  The lerp stays in its factored int32
// form (L0 + D*w) >> 14, hoisted per subset and channel, so no product can
// overflow; the 3-subset modes keep 3x4 (L0, D) pairs live, whose register
// cost `-Xptxas -v` reports per instantiation.  Stores of neighbouring
// threads are 64 bytes apart, so each warp-wide 16-byte store touches every
// fourth 16-byte segment; warp-cooperative stores are later work.
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
