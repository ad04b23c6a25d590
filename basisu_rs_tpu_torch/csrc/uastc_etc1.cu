// K4 on Hopper: UASTC 4x4 -> ETC1, one hand-written CUDA kernel per UASTC
// mode (uastc_kernel<Etc1<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("etc1", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/etc.py::uastc_to_etc1_mode.  The per-block logic is in
// uastc_etc.cuh over K3's texel decode (uastc_rgba.cuh, uastc_decode.cuh),
// the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: the function needs 25 bytes of HBM a block
// (16 in, 8 out, a 1-byte error flag; the dispatch's int64 index list adds
// 8 more): at 2^23 blocks 0.063 ms at 3.35 TB/s.  Against that stands the
// instruction count: the RGB decode of 16 texels (in the multi-subset modes
// a select over the subsets for each channel's lerp), 16 luminances, the
// subblock averages, the bias rule, two 4-level palettes and 16 selectors,
// all integer: 525-1,199 SASS instructions a block with a lerp and a
// compare-select search a texel, issue-bound at 66-79% of the issue rate.
//
// What the design does about it: one thread per block, one 16-byte load and
// one 8-byte store, in place through the index list.  A texel's RGB is a
// function of its (subset, weight) or (weight, weight) key, so in every mode
// of at most 16 keys (all but mode 18) the lerp runs once a key, with the
// subset and the weight known at compile time, into a per-thread table of
// (RGB packed for the quad sums, luminance) in shared memory, [key][thread]
// so a warp's loads meet no bank twice; each texel then costs its key (one
// field of the weight stream, its subset ORed in), one 8-byte load and one
// add into its packed 2x2-quad sum.  The flip bit only selects which quad
// sums form a subblock and which thresholds the two off-diagonal quads
// meet, once per block; the bias rule is selects, not branches; each
// selector's two wire bits are the signs of luminance minus threshold,
// shifted into the selector word by SHF.L.W in pixel-id order.  The four
// ETC tables (under 0.4 KB) are read with __ldg.  Measured with
// chip_smoke.py and tools/csrc_ab.py (H100 80GB HBM3, 700 W): 511-913
// instructions a block outside mode 8, 48 registers; the 19 launches of
// the 2^23-block all-mode cell 0.349 -> 0.287 ms; at 2^23 contiguous
// blocks every mode but 8 runs at 79-87% of its issue bound: still
// issue-bound.
#include "uastc_etc.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Etc1 {
  static constexpr int kOutBytes = 8;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[2]) { return ub::uastc_to_etc1<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 8-byte ETC1 rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_etc1_launch(int mode, const void* in, const void* index, int n, void* out,
                                 void* err, void* stream) {
  return ub::launch<Etc1>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_etc1_warps(int mode, int* warps) { return ub::resident_warps<Etc1>(mode, warps); }
