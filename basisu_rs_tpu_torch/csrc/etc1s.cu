// K6-K9 on Hopper: the ETC1S back-end, one hand-written CUDA kernel per kind
// (etc1s_kernel<KIND>: 0 RGBA, 1 alpha, 2 RGBA + alpha slice, 3 ETC1), built
// for sm_90a.
//
// Replaces the TPU kernels basisu_rs_tpu/ops/etc1s_pallas.py::_build(kind)
// (pl.pallas_call at :230; bodies _rgba_kernel_body :131,
// _rgba_alpha_kernel_body :158 and the "etc1" branch :202-213).  The
// per-block logic is in etc1s.cuh.
//
// What bounds it on the H100: bytes.  The function reads two uint16 indices
// a block (four for K8) and writes 64 B of texels (K6-K8) or 8 B of ETC1
// (K9): 68, 68, 72 and 12 B a block, 0.170, 0.170, 0.180 and 0.030 ms at
// 2^23 blocks and 3.35 TB/s.  The work is a palette (3 clamps a level) and
// a 2-bit select a texel, a few integer operations a byte.
//
// What the design does about it:
//   - Codebooks are read through __ldg and not staged in shared memory: at
//     2^23 blocks and 256 threads a CTA, a copy per CTA of two 8 KiB
//     codebooks would move as many bytes from L2 as K6 writes, and a file's
//     codebook may hold 65,535 entries (256 KiB, more than a CTA's shared
//     memory).  An 8 KiB codebook stays in L1/L2.
//   - K6-K8: four threads a block, one texel row each, so a warp writes 512
//     contiguous bytes in one 16-byte store a thread; the four threads read
//     the same two index values and codebook words (L1 hits).
//   - K9: one thread a block, one 8-byte store (a warp writes 256
//     contiguous bytes).
//   - Indices stay uint16 on the card, as the front-end emits them.
#include "etc1s.cuh"

#include <cuda_runtime.h>

namespace ub {

constexpr int kEtc1sThreads = 256;

template <int KIND>
__global__ void __launch_bounds__(kEtc1sThreads)
    etc1s_kernel(const uint32_t* __restrict__ ep_tab, uint32_t n_ep, const uint32_t* __restrict__ sel_tab,
                 uint32_t n_sel, const uint16_t* __restrict__ i0, const uint16_t* __restrict__ i1,
                 const uint16_t* __restrict__ i2, const uint16_t* __restrict__ i3, int n, void* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kEtc1sThreads + threadIdx.x;
  if constexpr (KIND == ETC1S_ETC1) {
    if (t >= n) return;
    uint32_t o[2];
    etc1s_etc1_block(etc1s_word(ep_tab, n_ep, __ldg(i0 + t)), etc1s_word(sel_tab, n_sel, __ldg(i1 + t)), o);
    static_cast<uint2*>(out)[t] = make_uint2(o[0], o[1]);
  } else {
    const long long b = t >> 2;  // block; thread t writes its row t & 3
    if (b >= n) return;
    const uint32_t ep = etc1s_word(ep_tab, n_ep, __ldg(i0 + b));
    const uint32_t sel = etc1s_word(sel_tab, n_sel, __ldg(i1 + b));
    uint32_t a_ep = 0, a_sel = 0;
    if constexpr (KIND == ETC1S_RGBA_ALPHA) {
      a_ep = etc1s_word(ep_tab, n_ep, __ldg(i2 + b));
      a_sel = etc1s_word(sel_tab, n_sel, __ldg(i3 + b));
    }
    uint32_t o[4];
    etc1s_row<KIND>(ep, sel, a_ep, a_sel, static_cast<int>(t & 3), o);
    static_cast<uint4*>(out)[t] = make_uint4(o[0], o[1], o[2], o[3]);  // 16 B at 64 b + 16 y
  }
}

using Etc1sKernelFn = void (*)(const uint32_t*, uint32_t, const uint32_t*, uint32_t, const uint16_t*,
                               const uint16_t*, const uint16_t*, const uint16_t*, int, void*);

}  // namespace ub

// One launch of kind `kind` over n blocks: ep_tab / sel_tab are the packed
// codebooks of n_ep / n_sel 32-bit words (sel_tab holds wire words for
// ETC1), i0..i3 uint16 index streams (endpoint, selector; K8 adds the alpha
// slice's endpoint and selector, the others pass null), out uint8 rows of 64
// B (16-byte aligned) or 8 B for ETC1 (8-byte aligned).  Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int etc1s_launch(int kind, const void* ep_tab, int n_ep, const void* sel_tab, int n_sel, const void* i0,
                            const void* i1, const void* i2, const void* i3, int n, void* out, void* stream) {
  using namespace ub;
  static const Etc1sKernelFn kKernels[ETC1S_KINDS] = {etc1s_kernel<ETC1S_RGBA>, etc1s_kernel<ETC1S_ALPHA>,
                                                      etc1s_kernel<ETC1S_RGBA_ALPHA>, etc1s_kernel<ETC1S_ETC1>};
  if (kind < 0 || kind >= ETC1S_KINDS || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (n_ep < 1 || n_sel < 1 || !i0 || !i1 || (kind == ETC1S_RGBA_ALPHA && (!i2 || !i3)))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long threads = kind == ETC1S_ETC1 ? n : 4LL * n;
    const unsigned grid = static_cast<unsigned>((threads + kEtc1sThreads - 1) / kEtc1sThreads);
    kKernels[kind]<<<grid, kEtc1sThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ep_tab), static_cast<uint32_t>(n_ep), static_cast<const uint32_t*>(sel_tab),
        static_cast<uint32_t>(n_sel), static_cast<const uint16_t*>(i0), static_cast<const uint16_t*>(i1),
        static_cast<const uint16_t*>(i2), static_cast<const uint16_t*>(i3), n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
