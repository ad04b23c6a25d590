// K5 on Hopper: UASTC 4x4 -> ETC2 RGBA (the EAC alpha block, then the ETC1
// block), one hand-written CUDA kernel per UASTC mode (uastc_kernel<Etc2<M>>,
// M = 0..18), built for sm_90a.
//
// Replaces the TPU kernel basisu_rs_tpu/ops/pallas_kernels.py::_pallas_build
// ("etc2", mode) (pl.pallas_call at :150), whose body is
// basisu_rs_tpu/ops/etc.py::uastc_to_etc2_mode.  The per-block logic is in
// uastc_etc.cuh over K3's texel decode (uastc_rgba.cuh, uastc_decode.cuh),
// the launch layout in uastc_launch.cuh.
//
// What bounds it on the H100: integer issue.  The function needs 33 bytes
// of HBM a block (16 in, 16 out, a 1-byte error flag; the dispatch's int64
// index list adds 8 more): at 2^23 blocks 0.083 ms at 3.35 TB/s.  Against
// that stand K4's whole ETC1 work and, in the alpha modes 9-17, the alpha
// range, the EAC centre and thresholds and 16 selector searches.  At 2^23
// contiguous blocks of one mode every mode but 8 runs at 69-78% of its
// issue bound (blocks / 32 x SASS instructions over 132 SMs x 4 issue
// slots) and under 40% of its HBM bound.
//
// What the design does about it: cut the instructions.  The ETC1 half is
// K4's (uastc_etc1.cu): RGB key tables in the RGB modes, packed quad sums,
// the branch-free bias rule and the selector word.  The EAC half takes two
// passes over the texels' alpha keys (subset, alpha-plane weight), which
// name each texel's alpha: pass 1 keeps only the range of keys present,
// since the lerp is monotone in the weight; the selectors are searched
// once a key (up to 8 keys) into a byte table that pass 2 reads with one
// PRMT a texel, or once a texel where 4-bit weights make 16 keys.  The
// search itself is branch-free: three lanes a multiply-add hold a - T[k],
// and the selector is a popcount of their top bits (uastc_etc.cuh).  No
// texel's alpha is kept.  Measured with chip_smoke.py and tools/csrc_ab.py
// (H100 80GB HBM3, 700 W): the 19 launches take 0.364 ms; 0.409 with K4's
// earlier ETC1 half (a lerp and a compare-select search a texel); 0.499
// before the alpha keys (alpha texels packed four a word, a 3-level compare
// search a texel that ptxas spread over 62 predicate spills in mode 17:
// 1,107-1,496 SASS instructions and 79-115 registers in the alpha modes,
// then 809-1,353 and 40-80).  Capping that design's registers instead
// (__launch_bounds__(256, 3) or (256, 4)) spilled 8-216 bytes in the alpha
// modes and saved under 2% (tools/csrc_ab.py, same card).
#include "uastc_etc.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Etc2 {
  static constexpr int kOutBytes = 16;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_etc2<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte ETC2 rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_etc2_launch(int mode, const void* in, const void* index, int n, void* out,
                                 void* err, void* stream) {
  return ub::launch<Etc2>(mode, in, index, n, out, err, stream);
}

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_etc2_warps(int mode, int* warps) { return ub::resident_warps<Etc2>(mode, warps); }
