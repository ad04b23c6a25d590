// P on Hopper: the fl_div255 hardware probe, one hand-written CUDA kernel
// (fl_div255_probe_kernel), built for sm_90a with the library's flags
// (--fmad=false).
//
// Replaces the probe kernels of tests/test_pbits.py:68 (pl.pallas_call at
// :73, interpret mode) and tests/test_tpu_hardware.py:76 (:80, on the
// chip): ub::fl_div255 (uastc_decode.cuh), the divide-free IEEE-f32 x/255
// that K1's shared p-bit search (uastc_bc7.cuh shared_pbit) relies on,
// evaluated on the card on int32 inputs.  The plain version is
// IEEE x / 255 in f32 (ops/fl_div255_probe.py).  For x in 0..255 the two
// must agree bit for bit; past 255 the identity is not claimed and the
// probe only records what the card computes.
//
// What bounds it: 8 bytes of HBM an element (4 in, 4 out) and three f32
// operations; at the probe's sizes (256 and 65,536 elements) the launch
// itself.  Design: one thread an element.
#include <cuda_runtime.h>

#include "uastc_decode.cuh"

namespace ub {

constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
    fl_div255_probe_kernel(const int32_t* __restrict__ x, float* __restrict__ out, int n) {
  const int t = blockIdx.x * kProbeThreads + threadIdx.x;
  if (t < n) out[t] = fl_div255(__ldg(x + t));
}

}  // namespace ub

// fl_div255 of the n int32 values x into the n floats out.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int fl_div255_launch(const void* x, int n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    ub::fl_div255_probe_kernel<<<(n + ub::kProbeThreads - 1) / ub::kProbeThreads, ub::kProbeThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(x),
                                                                      static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
