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
// search and bit packing.  Measured on an H100 80GB HBM3 at a 700 W limit
// (chip_smoke.py phase 23), over 2^23 contiguous blocks of one mode: the
// light modes run at 72-85% of the HBM bound; the multi-subset modes 2, 3,
// 4, 7, 9 and 16 are bound by integer issue (65-79% of the issue bound at
// 286-592 SASS instructions a block; 492-769 when each of their 16 weights
// was read, inverted and written on its own).  On the main path each mode's
// group is 1/19 of the batch, ~1.6 waves a launch, so the launch's ramp and
// its half-empty last wave count too.
//
// What the design does about it:
//   - one thread per block, one 16-byte load and one 16-byte store, so every
//     byte moves once, coalesced within a mode group, in place through the
//     index list;
//   - the weight field, in every mode whose UASTC and BC7 weight widths
//     match (0-4, 7, 9, 10, 15, 16), is built as one word from the weight
//     stream: the invert flag of each BC7 subset is one bit of it, the
//     inverted subsets are one XOR, the anchors' MSBs are dropped by
//     remove_zero, and one put writes the field (uastc_bc7.cuh); the other
//     modes read each weight where they write it, so no array of 16 weights
//     stays live through the p-bit search;
//   - the launches of one dispatch are chained (Bc7::kChained,
//     ub::launch_chained: programmatic dependent launch), so the next mode's
//     CTAs fill the SMs a launch's last wave leaves idle; each kernel waits
//     for the launch ahead of it before it stores (uastc_launch.cuh);
//   - the pattern-indexed tables (under 4 KB together) are read through the
//     read-only cache with __ldg rather than __constant__, whose divergent
//     indices would serialise.
// Registers and spills of every instantiation come from `-Xptxas -v` at
// build time (chip_smoke.py phase 2).
#include "uastc_bc7.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Bc7 {
  static constexpr int kOutBytes = 16;
  static constexpr bool kChained = true;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_bc7<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_bc7_launch(int mode, const void* in, const void* index, int n, void* out,
                                void* err, void* stream) {
  return ub::launch<Bc7>(mode, in, index, n, out, err, stream);
}

// The same, chained to the launch ahead of it on `stream` (programmatic
// dependent launch); see ub::launch_chained for what the caller keeps.
extern "C" int uastc_bc7_launch_chained(int mode, const void* in, const void* index, int n, void* out,
                                        void* err, void* stream) {
  return ub::launch_chained<Bc7>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_bc7_warps(int mode, int* warps) { return ub::resident_warps<Bc7>(mode, warps); }
