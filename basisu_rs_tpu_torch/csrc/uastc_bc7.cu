// K1 on Hopper: UASTC 4x4 -> BC7, one hand-written CUDA kernel per UASTC
// mode (uastc_bc7_kernel<M>, M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("bc7", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/bc7.py::uastc_to_bc7_mode.  The per-block logic is in
// uastc_bc7.cuh; this file holds only the launch layout.
//
// What bounds it on the H100: each block moves 41 bytes of HBM (16 in, 16
// out, an 8-byte index and a 1-byte error flag) against a few hundred
// integer instructions of decode, p-bit search and bit packing.  Measured on
// an H100 80GB HBM3 at a 700 W limit, over 2^23 contiguous blocks: the light
// mode 8 takes 0.098 ms, as long as a plain 128 MiB copy (0.094 ms), so it
// is HBM-bound; the heavy mode 2 takes 0.265 ms, 2.8x the copy, so it is
// bound by integer issue.  On the main path each mode's group is 1/19 of
// the batch and one launch is 0.008-0.020 ms, short enough that launch
// ramp and tail count too.
//
// What the design does about it: one thread per block, one 16-byte load
// (ld.global.nc.v4) and one 16-byte store, so every byte is moved once and
// coalesced within a mode group; blocks are read and written in place
// through the dispatcher's per-mode index list, so there is no separate
// gather or scatter pass.  The mode is a template parameter, so every bit
// offset and loop folds into straight-line code with no mode branches, and
// the pattern-indexed tables (under 4 KB together) are read through the
// read-only cache with __ldg rather than __constant__, whose divergent
// indices would serialise.  Register pressure in the heavy modes (2, 3, 4,
// 7, 9, 16) is reported per instantiation by `-Xptxas -v` at build time
// (at most 48 registers and no spills for sm_90a with nvcc 12.9).
#include <cuda_runtime.h>

#include "uastc_bc7.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void __launch_bounds__(kThreads)
    uastc_bc7_kernel(const uint4* __restrict__ in, const long long* __restrict__ index, int n,
                     uint4* __restrict__ out, uint8_t* __restrict__ err) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long row = index != nullptr ? __ldg(index + t) : t;
  const uint4 v = __ldg(in + row);
  const uint32_t l[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
  const bool e = ub::uastc_to_bc7<M>(l, o);
  out[row] = make_uint4(o[0], o[1], o[2], o[3]);
  err[row] = e ? 1 : 0;
}

template <int M>
cudaError_t launch(const void* in, const void* index, int n, void* out, void* err,
                   cudaStream_t stream) {
  if (n > 0) {
    uastc_bc7_kernel<M><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const uint4*>(in), static_cast<const long long*>(index), n,
        static_cast<uint4*>(out), static_cast<uint8_t*>(err));
  }
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, const void*, int, void*, void*, cudaStream_t);

const LaunchFn kLaunch[19] = {
    launch<0>,  launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>, launch<13>,
    launch<14>, launch<15>, launch<16>, launch<17>, launch<18>,
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into
// out[index[t]] / err[index[t]]; index == nullptr means rows 0..n-1.
// in/out: 16-byte aligned [rows, 16] uint8; index: int64; err: uint8.
// Launches on `stream` and does not synchronise.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int uastc_bc7_launch(int mode, const void* in, const void* index, int n, void* out,
                                void* err, void* stream) {
  if (mode < 0 || mode >= 19 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[mode](in, index, n, out, err, static_cast<cudaStream_t>(stream)));
}
