// The launch layout shared by the per-mode UASTC kernels K1 (BC7), K2 (ASTC),
// K3 (RGBA), K4 (ETC1) and K5 (ETC2): one thread per block, one 16-byte load
// of the UASTC block, the Op::kOutBytes bytes of the result in the widest
// stores that fit (one 8-byte store for ETC1's 8 bytes; 16-byte stores for
// the 16 bytes of BC7, ASTC and ETC2 and RGBA's 64 bytes of texels) and a
// 1-byte error flag, all read and written in place through the dispatcher's
// per-mode index list, so there is no separate gather or scatter pass.
//
// Op<M> is one target's per-block transcode for UASTC mode M:
//   static constexpr int kOutBytes;  // 8 or a multiple of 16
//   static __device__ bool run(const uint32_t (&l)[4], uint32_t (&o)[kOutBytes / 4]);
// The mode is a template parameter, so every bit offset and loop folds into
// straight-line code with no mode branches.
#pragma once
#include <cuda_runtime.h>

#include <utility>

#include "uastc_decode.cuh"

namespace ub {

constexpr int kThreads = 256;

template <class Op>
__global__ void __launch_bounds__(kThreads)
    uastc_kernel(const uint4* __restrict__ in, const long long* __restrict__ index, int n,
                 void* __restrict__ out, uint8_t* __restrict__ err) {
  static_assert(Op::kOutBytes == 8 || Op::kOutBytes % 16 == 0, "output rows are 8 bytes or 16-byte vectors");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long row = index != nullptr ? __ldg(index + t) : t;
  const uint4 v = __ldg(in + row);
  const uint32_t l[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[Op::kOutBytes / 4];
  const bool e = Op::run(l, o);
  if constexpr (Op::kOutBytes == 8) {
    static_cast<uint2*>(out)[row] = make_uint2(o[0], o[1]);
  } else {
    constexpr int kVecs = Op::kOutBytes / 16;
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      static_cast<uint4*>(out)[row * kVecs + j] = make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
  err[row] = e ? 1 : 0;
}

using KernelFn = void (*)(const uint4*, const long long*, int, void*, uint8_t*);

template <template <int> class Op, int... M>
int launch_mode(int mode, const void* in, const void* index, int n, void* out, void* err,
                void* stream, std::integer_sequence<int, M...>) {
  static const KernelFn kKernels[] = {uastc_kernel<Op<M>>...};
  if (mode < 0 || mode >= static_cast<int>(sizeof...(M)) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    kKernels[mode]<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<const long long*>(index), n, out,
        static_cast<uint8_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch Op<mode> over the n blocks in[index[t]] (index == nullptr: rows
// 0..n-1) into out / err at the same rows.  in: 16-byte aligned rows of 16
// bytes; out: rows of Op::kOutBytes bytes, aligned to min(16, kOutBytes);
// index: int64; err: uint8.  Launches on `stream` without synchronising;
// returns the launch's cudaError_t.
template <template <int> class Op>
int launch(int mode, const void* in, const void* index, int n, void* out, void* err, void* stream) {
  return launch_mode<Op>(mode, in, index, n, out, err, stream, std::make_integer_sequence<int, 19>{});
}

}  // namespace ub
