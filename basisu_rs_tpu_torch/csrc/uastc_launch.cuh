// The launch layouts of the UASTC kernels K1 (BC7), K2 (ASTC), K3 (RGBA), K4
// (ETC1) and K5 (ETC2).
//
// uastc_kernel<Op<M>>, one kernel a mode: one thread decodes each block from
// one 16-byte load of the UASTC block, and the result and a 1-byte error flag
// are read and written in place through the dispatcher's per-mode index
// list, so there is no separate gather or scatter pass.  The dispatch sends
// one launch per present mode for ASTC, RGBA, ETC1 and ETC2; K1's per-mode
// kernels serve the tools and the comparisons of chip_smoke.py.
//
// uastc_kernel_tiles<Op> (bottom of this file), every mode in one launch: the
// dispatch's one launch a shard for BC7.  Each CTA buckets its own tile of
// blocks by mode in shared memory (uastc_tiles.cuh) and runs whole warps of
// one mode, so there is no index, no device-wide sort and no host read.
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
// Op<M> is one target's per-block transcode for UASTC mode M:
//   static constexpr int kOutBytes;  // 8, 16 or 64
//   static __device__ bool run(const uint32_t (&l)[4], uint32_t (&o)[kOutBytes / 4]);
// The mode is a template parameter, so every bit offset and loop folds into
// straight-line code with no mode branches.
#pragma once
#include <cuda_runtime.h>

#include <atomic>
#include <utility>

#include "uastc_decode.cuh"
#include "uastc_tiles.cuh"

namespace ub {

// Staged-row slot of chunk c (0..3) of a warp's row r (0..31), 16-byte units.
__device__ __forceinline__ int staged_chunk(int r, int c) { return 4 * r + (c ^ ((r >> 1) & 3)); }

template <class Op>
__global__ void __launch_bounds__(kThreads)
    uastc_kernel(const uint4* __restrict__ in, const long long* __restrict__ index, int n,
                 void* __restrict__ out, uint8_t* __restrict__ err) {
  static_assert(Op::kOutBytes == 8 || Op::kOutBytes == 16 || Op::kOutBytes == 64, "rows of 8, 16 or 64 bytes");
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
    if (t >= n) return;
    const long long row = index != nullptr ? __ldg(index + t) : t;
    const uint4 v = __ldg(in + row);
    const uint32_t l[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[Op::kOutBytes / 4];
    const bool e = Op::run(l, o);
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

// ---- every mode in one launch: uastc_kernel_tiles<Op> -----------------------
//
// One CTA a tile of kTileBlocks contiguous blocks (the last one ragged): the
// CTA loads its tile into shared memory, 16 bytes a thread, coalesced;
// buckets the tile's positions by mode (uastc_tiles.cuh: a stable counting
// sort with each mode's run padded to whole warps); then each warp takes
// rounds of 32 slots of one mode, one warp-uniform switch on the mode a
// round, and writes each output row over its input row and each err flag
// over its mode byte; last, the CTA stores the tile's rows and err bytes
// back, coalesced, at the blocks' own rows.  So every byte moves once (16 in,
// 16 out, 1 err: 33 B a block) with no index, no device-wide sort and no host
// read.  With rounds != nullptr each CTA adds its warp-rounds to *rounds.
// Op<M>::run is the per-mode kernels' own, so every byte and err flag equals
// theirs.
template <template <int> class Op>
__global__ void __launch_bounds__(kTileThreads, kTileCtas)
    uastc_kernel_tiles(const uint4* __restrict__ in, int n, uint4* __restrict__ out, uint8_t* __restrict__ err,
                       unsigned long long* __restrict__ rounds) {
  static_assert(Op<0>::kOutBytes == 16, "the tile kernel writes each output row over its 16-byte block");
  extern __shared__ uint4 tile_smem[];
  TileShared& s = *reinterpret_cast<TileShared*>(tile_smem);
  uint4* const rows = reinterpret_cast<uint4*>(s.rows);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTileBlocks;
  const int count = n - base < kTileBlocks ? static_cast<int>(n - base) : kTileBlocks;
  constexpr int kPer = kTileBlocks / kTileThreads;
  static_assert(kPer * kTileThreads == kTileBlocks, "a tile of whole rows of the CTA");
  uint4 v[kPer];  // every load of the tile in flight before the first is used
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = k * kTileThreads + tid;
    if (p < count) v[k] = __ldg(in + base + p);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = k * kTileThreads + tid;
    uint8_t m = kNoMode;
    if (p < count) {
      rows[p] = v[k];
      m = tile_mode(v[k].x);
    }
    s.modes[p] = m;
  }
  __syncthreads();
  tile_count(tid, kTileThreads, s);
  __syncthreads();
  tile_scan(tid, kTileThreads, s);
  __syncthreads();
  tile_totals(tid, kTileThreads, s);
  __syncthreads();
  tile_starts(tid, kTileThreads, s);
  __syncthreads();
  tile_place(tid, kTileThreads, s);
  __syncthreads();
  const int32_t n_rounds = tile_rounds(s);
  for (int32_t r = tid >> 5; r < n_rounds; r += kTileThreads / 32) tile_lane<Op>(s, tile_round_mode(s, r), r, tid & 31);
  __syncthreads();
  for (int p = tid; p < count; p += kTileThreads) {
    out[base + p] = rows[p];
    err[base + p] = s.modes[p];
  }
  if (rounds != nullptr && tid == 0) atomicAdd(rounds, static_cast<unsigned long long>(n_rounds));
}

// Allow uastc_kernel_tiles<Op> its shared memory, above the 48 KiB of
// static shared memory, on the current device: the attribute is a device's,
// so it is set once for each device (bit d of `done`) and not on every launch.
template <template <int> class Op>
cudaError_t tile_smem_attribute() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  rc = cudaFuncSetAttribute(uastc_kernel_tiles<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(sizeof(TileShared)));
  if (rc == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return rc;
}

// Launch uastc_kernel_tiles<Op> over the n blocks `in` into out / err at the
// same rows (in and out 16-byte aligned rows of 16 bytes, err uint8), adding
// the warp-rounds to *rounds unless rounds is null.  Launches on `stream`
// without synchronising; returns the launch's cudaError_t.
template <template <int> class Op>
int launch_tiles(const void* in, int n, void* out, void* err, void* rounds, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaSuccess;
  if (n > 0) {
    rc = tile_smem_attribute<Op>();
    const unsigned int tiles = static_cast<unsigned int>((static_cast<long long>(n) + kTileBlocks - 1) / kTileBlocks);
    if (rc == cudaSuccess)
      uastc_kernel_tiles<Op><<<tiles, kTileThreads, sizeof(TileShared), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(in), n, static_cast<uint4*>(out), static_cast<uint8_t*>(err),
          static_cast<unsigned long long*>(rounds));
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// Warps of uastc_kernel_tiles<Op> resident on one SM, as the runtime's
// occupancy calculator gives them, into *warps; returns the cudaError_t.
template <template <int> class Op>
int resident_warps_tiles(int* warps) {
  int ctas = 0;
  cudaError_t rc = tile_smem_attribute<Op>();
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, uastc_kernel_tiles<Op>, kTileThreads,
                                                       sizeof(TileShared));
  *warps = ctas * (kTileThreads / 32);
  return static_cast<int>(rc);
}

}  // namespace ub
