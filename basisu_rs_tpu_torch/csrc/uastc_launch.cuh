// The launch layout shared by the per-mode UASTC kernels K1 (BC7), K2 (ASTC),
// K3 (RGBA), K4 (ETC1) and K5 (ETC2): one thread decodes each block from one
// 16-byte load of the UASTC block, and the result and a 1-byte error flag are
// read and written in place through the dispatcher's per-mode index list, so
// there is no separate gather or scatter pass.
//
// The stores follow the row size:
//   - 8 bytes (ETC1) and 16 bytes (BC7, ASTC, ETC2): each thread writes its
//     own row in one 8- or 16-byte store, so a warp writes 256 or 512
//     contiguous bytes where the index's rows are contiguous.
//   - 64 bytes (RGBA): a thread's own row would take four 16-byte stores 64
//     bytes apart, so every warp-wide store would fill half of each 32-byte
//     sector it touches.  Instead the warp stages its 32 rows in shared
//     memory (2 KiB a warp, 16 KiB a CTA) and writes them back cooperatively:
//     in round k = 0..3, lane l stores 16-byte chunk l & 3 of the row decoded
//     by lane 8k + (l >> 2), whose row index comes by __shfl_sync.  Each
//     warp-wide store then writes eight whole 64-byte rows, 512 contiguous
//     bytes when the rows are contiguous.  Chunk c of staged row r sits at
//     slot c ^ ((r >> 1) & 3) of the row, so neither the staging stores (one
//     chunk of rows 0..7 a phase) nor the reads (all chunks of two rows a
//     phase) meet a bank twice.  Every lane reaches the rounds, including the
//     lanes past n of the last warp, whose rows are masked out of the stores.
//     Measured with chip_smoke.py (H100 80GB HBM3, 700 W): K3's
//     19 launches of the 2^23-block all-mode cell take 0.382 ms against
//     0.663 ms with each thread's four 16-byte stores.
//
// Chained launches (K1, whose Op declares kChained = true): the dispatch
// launches one kernel per present mode, each a grid of ~1.6 waves whose last
// wave drains with the SMs half empty.  launch_chained issues a launch with
// programmatic dependent launch (Hopper): each CTA of a chained kernel first
// executes griddepcontrol.launch_dependents, so the next launch of the
// stream, if it is chained too, may start its CTAs on the SMs this grid's
// last wave leaves idle; each thread then executes griddepcontrol.wait
// before its stores, which returns once every earlier grid of the stream
// has completed and its writes are visible.  So a chained launch stores
// nothing before the launch ahead of it has completed, and completes after
// it, and a plain launch or copy that follows the chain sees every row.  A
// chained kernel reads its blocks and index before the wait: the caller
// chains only a launch whose inputs no grid still running writes (the
// dispatch chains each mode's launch to the one before it; the first launch
// of a call is a plain one).  A plain launch of the same kernel waits for
// the grids ahead in the usual way, and its griddepcontrol instructions do
// nothing.
//
// Op<M> is one target's per-block transcode for UASTC mode M:
//   static constexpr int kOutBytes;  // 8, 16 or 64
//   static constexpr bool kChained;  // optional: true where launch_chained serves it
//   static __device__ bool run(const uint32_t (&l)[4], uint32_t (&o)[kOutBytes / 4]);
// The mode is a template parameter, so every bit offset and loop folds into
// straight-line code with no mode branches.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "uastc_decode.cuh"

namespace ub {

// Op::kChained where Op declares it, else false.
template <class Op, class = void>
constexpr bool kChained = false;
template <class Op>
constexpr bool kChained<Op, std::void_t<decltype(Op::kChained)>> = Op::kChained;

// Staged-row slot of chunk c (0..3) of a warp's row r (0..31), 16-byte units.
__device__ __forceinline__ int staged_chunk(int r, int c) { return 4 * r + (c ^ ((r >> 1) & 3)); }

template <class Op>
__global__ void __launch_bounds__(kThreads)
    uastc_kernel(const uint4* __restrict__ in, const long long* __restrict__ index, int n,
                 void* __restrict__ out, uint8_t* __restrict__ err) {
  static_assert(Op::kOutBytes == 8 || Op::kOutBytes == 16 || Op::kOutBytes == 64, "rows of 8, 16 or 64 bytes");
  static_assert(!kChained<Op> || Op::kOutBytes != 64, "chained launches store rows of 8 or 16 bytes");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (Op::kOutBytes == 64) {
    __shared__ uint4 stage[kThreads * 4];
    const int lane = threadIdx.x & 31;
    uint4* const ws = stage + (threadIdx.x - lane) * 4;  // this warp's 32 rows
    long long row = -1;
    if (t < n) {
      row = index != nullptr ? __ldg(index + t) : t;
      const uint4 v = __ldg(in + row);
      const uint32_t l[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[16];
      err[row] = Op::run(l, o) ? 1 : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ws[staged_chunk(lane, c)] = make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    }
    __syncwarp();
    const int c = lane & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 8 * k + (lane >> 2);
      const long long dst = __shfl_sync(0xFFFFFFFFu, row, r);
      if (dst >= 0) static_cast<uint4*>(out)[dst * 4 + c] = ws[staged_chunk(r, c)];
    }
  } else {
    if constexpr (kChained<Op>) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if (t >= n) return;
    const long long row = index != nullptr ? __ldg(index + t) : t;
    const uint4 v = __ldg(in + row);
    const uint32_t l[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[Op::kOutBytes / 4];
    const bool e = Op::run(l, o);
    if constexpr (kChained<Op>) asm volatile("griddepcontrol.wait;" ::: "memory");
    if constexpr (Op::kOutBytes == 8) static_cast<uint2*>(out)[row] = make_uint2(o[0], o[1]);
    else static_cast<uint4*>(out)[row] = make_uint4(o[0], o[1], o[2], o[3]);
    err[row] = e ? 1 : 0;
  }
}

using KernelFn = void (*)(const uint4*, const long long*, int, void*, uint8_t*);

template <template <int> class Op, int... M>
const KernelFn* mode_kernels(std::integer_sequence<int, M...>) {
  static const KernelFn kKernels[] = {uastc_kernel<Op<M>>...};
  return kKernels;
}

template <template <int> class Op>
const KernelFn* kernels() {
  return mode_kernels<Op>(std::make_integer_sequence<int, 19>{});
}

// Launch Op<mode> over the n blocks in[index[t]] (index == nullptr: rows
// 0..n-1) into out / err at the same rows.  in: 16-byte aligned rows of 16
// bytes; out: rows of Op::kOutBytes bytes, aligned to min(16, kOutBytes);
// index: int64; err: uint8.  Launches on `stream` without synchronising;
// returns the launch's cudaError_t.
template <template <int> class Op>
int launch(int mode, const void* in, const void* index, int n, void* out, void* err, void* stream) {
  if (mode < 0 || mode >= 19 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    kernels<Op>()[mode]<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<const long long*>(index), n, out, static_cast<uint8_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}

// launch, chained to the launch ahead of it on `stream`: one
// cudaLaunchKernelEx with programmatic stream serialization allowed (see
// the top of this file).  Returns the launch's cudaError_t.
template <template <int> class Op>
int launch_chained(int mode, const void* in, const void* index, int n, void* out, void* err, void* stream) {
  static_assert(kChained<Op<0>>, "launch_chained serves kernels that wait before their stores");
  if (mode < 0 || mode >= 19 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaSuccess;
  if (n > 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + kThreads - 1) / kThreads);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, kernels<Op>()[mode], static_cast<const uint4*>(in),
                            static_cast<const long long*>(index), n, out, static_cast<uint8_t*>(err));
  }
  const cudaError_t last = cudaGetLastError();  // clears the error state a failed launch leaves
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// Warps of Op<mode>'s kernel resident on one SM at kThreads a CTA, as the
// runtime's occupancy calculator gives them (registers, shared memory and
// the CTA limit), into *warps; returns the cudaError_t.
template <template <int> class Op>
int resident_warps(int mode, int* warps) {
  if (mode < 0 || mode >= 19) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernels<Op>()[mode], kThreads, 0);
  *warps = ctas * (kThreads / 32);
  return static_cast<int>(rc);
}

}  // namespace ub
