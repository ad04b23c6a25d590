// K2 on Hopper: UASTC 4x4 -> ASTC 4x4, one hand-written CUDA kernel per
// UASTC mode (uastc_kernel<Astc<M>>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("astc", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/astc.py::uastc_to_astc_mode.  The per-block logic is in
// uastc_astc.cuh and uastc_decode.cuh, the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: like K1, 33 bytes of HBM a block (16 in, 16
// out, a 1-byte error flag; the dispatch's int64 index list adds 8 more)
// against the integer work of the decode, the blue-contraction check (up
// to 18 endpoint unquantizations), the ISE re-encode and 16-32 bit-reversed
// weight writes: at 2^23 blocks the 33 bytes alone take 0.083 ms at
// 3.35 TB/s.
//
// What the design does about it: the same one-thread-per-block layout as
// K1, every byte moved once, in place through the index list; the mode as a
// template parameter, so the ISE group layout, the slice widths and every
// weight offset are compile-time constants (no shift reaches 32: `put`
// keeps the `w + 1 < 4` guard); the quint/trit pack LUTs (125 and 243
// bytes) and the partition seeds are read with __ldg, since their indices
// diverge.
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
