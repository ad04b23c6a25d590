// K1 on Hopper: UASTC 4x4 -> BC7, one hand-written CUDA kernel per UASTC
// mode (uastc_kernel<Bc7<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("bc7", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/bc7.py::uastc_to_bc7_mode.  The per-block logic is in
// uastc_bc7.cuh and uastc_decode.cuh, the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: the function needs 33 bytes of HBM a block
// (16 in, 16 out, a 1-byte error flag; the dispatch's int64 index list adds
// 8 more) against a few hundred integer instructions of decode, p-bit
// search and bit packing.  Measured on
// an H100 80GB HBM3 at a 700 W limit, over 2^23 contiguous blocks: the light
// mode 8 takes 0.098 ms, as long as a plain 128 MiB copy (0.094 ms), so it
// is HBM-bound; the heavy mode 2 takes 0.265 ms, 2.8x the copy, so it is
// bound by integer issue.  On the main path each mode's group is 1/19 of
// the batch and one launch is 0.008-0.020 ms, short enough that launch
// ramp and tail count too.
//
// What the design does about it: one thread per block, one 16-byte load
// and one 16-byte store, so every byte is moved once and coalesced within a
// mode group, in place through the index list.  The pattern-indexed tables
// (under 4 KB together) are read through the read-only cache with __ldg
// rather than __constant__, whose divergent indices would serialise.
// Register pressure in the heavy modes (2, 3, 4, 7, 9, 16) is reported per
// instantiation by `-Xptxas -v` at build time.
#include "uastc_bc7.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Bc7 {
  static constexpr int kOutBytes = 16;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_bc7<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_bc7_launch(int mode, const void* in, const void* index, int n, void* out,
                                void* err, void* stream) {
  return ub::launch<Bc7>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_bc7_warps(int mode, int* warps) { return ub::resident_warps<Bc7>(mode, warps); }
