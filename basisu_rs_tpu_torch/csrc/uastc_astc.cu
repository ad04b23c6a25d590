// K2 on Hopper: UASTC 4x4 -> ASTC 4x4, one hand-written CUDA kernel per
// UASTC mode (uastc_kernel<Astc<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("astc", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/astc.py::uastc_to_astc_mode.  The per-block logic is in
// uastc_astc.cuh and uastc_decode.cuh, the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: like K1, 33 bytes of HBM a block (16 in, 16
// out, a 1-byte error flag; the dispatch's int64 index list adds 8 more),
// 0.083 ms at 2^23 blocks at 3.35 TB/s, against the integer work of the
// decode, the blue-contraction check (up to 18 endpoint unquantizations)
// and the ISE re-encode.  In the first design the weights cost most: each
// of the 16-32 weights was extracted, given its subset's invert mask,
// bit-reversed one bit at a time and put, 73-92% of the SASS of every mode
// with 16 weights or more, rolled by ptxas into loops.
//
// What the design does about it: one thread per block, every byte moved
// once, in place through the index list; the mode as a template
// parameter, so the ISE group layout, the slice widths and every field
// offset are compile-time constants (no shift reaches 32: `put` keeps the
// `w + 1 < 4` guard).  The ASTC weight field is the 128-bit reversal of the
// weight stream (uastc_decode.cuh): the UASTC weight field with a zero bit
// put back above each anchor, at compile-time positions or, in the
// multi-subset modes, at the pattern's one or two anchors; XORed with the
// swapped subsets' fields (the subset map's bit a texel, times 3 for 2-bit
// weights, spread in four shifts for 3-bit ones); then three BREVs.  The
// weights take 4-41 instructions a block and no loop.  The quint/trit pack
// LUTs and the partition tables are read with __ldg, since their indices
// diverge.  Measured with chip_smoke.py and tools/csrc_ab.py (H100 80GB
// HBM3, 700 W): the 19 launches of the 2^23-block all-mode cell 0.300 ->
// 0.204 ms, every mode 0.008-0.013 ms; at 2^23 contiguous blocks of one
// mode 15 of the 19 modes run at 84-86% of the HBM bound, the rest
// (3, 4, 7, with their ISE re-encode) at 63-72% of the issue bound.
#include "uastc_astc.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Astc {
  static constexpr int kOutBytes = 16;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_astc<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte ASTC rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_astc_launch(int mode, const void* in, const void* index, int n, void* out,
                                 void* err, void* stream) {
  return ub::launch<Astc>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_astc_warps(int mode, int* warps) { return ub::resident_warps<Astc>(mode, warps); }
