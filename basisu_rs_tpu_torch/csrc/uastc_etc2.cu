// K5 on Hopper: UASTC 4x4 -> ETC2 RGBA (the EAC alpha block, then the ETC1
// block), one hand-written CUDA kernel per UASTC mode (uastc_kernel<Etc2<M>>,
// M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("etc2", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/etc.py::uastc_to_etc2_mode.  The per-block logic is in
// uastc_etc.cuh over K3's texel decode (uastc_rgba.cuh, uastc_decode.cuh),
// the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: the function needs 33 bytes of HBM a block
// (16 in, 16 out, a 1-byte error flag; the dispatch's int64 index list adds
// 8 more): at 2^23 blocks 0.083 ms at 3.35 TB/s.  Against that stands K4's
// work plus, in the alpha modes, the 16 alpha lerps, the EAC centre (three
// f32 operations), 8 clamped candidate values and a 3-compare rank search
// per texel.
//
// What the design does about it: K4's streaming layout, with each texel's
// alpha packed 4 to a word and the min and max tracked as it streams; the
// duplicate-run fixups of the selector search are folded into the seven
// thresholds once per block, so a texel costs 3 compares and 4 selects; the
// 16 three-bit selectors accumulate in one 64-bit payload; the RGB modes
// skip the whole alpha search and write the solid-255 block.  One 16-byte
// store a block.
#include "uastc_etc.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Etc2 {
  static constexpr int kOutBytes = 16;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_etc2<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte ETC2 rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_etc2_launch(int mode, const void* in, const void* index, int n, void* out,
                                 void* err, void* stream) {
  return ub::launch<Etc2>(mode, in, index, n, out, err, stream);
}
