// K1 on Hopper: UASTC 4x4 -> BC7, built for sm_90a: one kernel over blocks of
// every mode (uastc_kernel_tiles<Bc7>, the main path: one launch a shard),
// and one kernel per UASTC mode (uastc_kernel<Bc7<M>>, M = 0..18: the plain
// comparisons, the tools and the stage kernels' reference).
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
// was read, inverted and written on its own).  Through the partition each
// mode's group is 1/19 of the batch, ~1.6 waves a launch, so the launch's
// ramp and its half-empty last wave count too.
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
//   - the pattern-indexed tables (under 4 KB together) are read through the
//     read-only cache with __ldg rather than __constant__, whose divergent
//     indices would serialise.
// Registers and spills of every instantiation come from `-Xptxas -v` at
// build time (chip_smoke.py phase 2).
//
// uastc_kernel_tiles<Bc7> (uastc_launch.cuh, uastc_tiles.cuh) replaces, on
// the main path, the dispatch's mode partition (a device-wide stable argsort,
// a bincount whose max and whose 20 counts the host read back: two syncs) and
// the 19 per-mode launches through its int64 index, whose rows lay scattered
// over the batch so that each 16-byte load and store took a sector of its
// own: 0.753 ms of K1 on the resident cell's shuffled 2^23 blocks, against
// 0.18 ms on phase 5's tiled ones (chip_smoke.py phase 26, H100 80GB HBM3,
// 700 W).  What bounds it: 33 bytes of HBM a block, 0.0826 ms for 2^23
// blocks; integer issue for the multi-subset modes 2, 3, 4, 7, 9 and 16; and
// here also the latency of each tile's serial steps (load, bucketing, store),
// which a CTA's barriers keep apart.  What the design does:
//   - a CTA takes a contiguous tile of T = 4,096 blocks, stages it in shared
//     memory (16 bytes a thread, every load in flight at once) and writes
//     each output row over its block and each err flag over its mode byte,
//     then stores the tile back coalesced: 33 B a block, no index (each
//     lane storing its own row and flag to global memory took 0.334 ms
//     against 0.214);
//   - a stable counting sort groups the tile's positions by mode, each run
//     padded to whole warps, so that a warp-round is one mode and one
//     warp-uniform branch, and every byte equals the per-mode kernels';
//   - warp w takes rounds w, w + 16, ...: the CTA's warps walk the runs in
//     mode order together, so few modes' code is live at once (a warp given
//     a contiguous share of the rounds ran 2x slower);
//   - the bucketing's steps keep to few barriers and no shared bank twice:
//     the counts mode-minor, the modes read four to a word, the scan in
//     chunks of 32 groups (0.280 -> 0.213 ms together);
//   - T and the CTA were chosen on the card (source variants A/B in one
//     call): with 512 threads and 64 registers two CTAs fit an SM; T =
//     4,096 at 512 threads beat 2,048/256, 4,096/256, 2,048/512 and
//     8,192/1,024 by 3-20%, and staging beat loading each lane's block from
//     global memory by 1.8-2.8x.
// Measured (chip_smoke.py phase 26): 0.2144 ms on the shuffled 2^23 blocks,
// 38.5% of the HBM bound, 0.2029 ms on the tiled golden mix, 64 registers,
// 32 warps/SM, 93.4% of its lanes carrying a block; the per-mode kernels
// take 0.116 ms over 2^23 contiguous blocks of one mode.
#include "uastc_bc7.cuh"
#include "uastc_launch.cuh"

namespace {

template <int M>
struct Bc7 {
  static constexpr int kOutBytes = 16;
  static UB_FN bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_bc7<M>(l, o); }
};

}  // namespace

// Transcode the n blocks in[index[t]] (all of UASTC mode `mode`) into the
// 16-byte rows out[index[t]] / err[index[t]]; see ub::launch.
extern "C" int uastc_bc7_launch(int mode, const void* in, const void* index, int n, void* out,
                                void* err, void* stream) {
  return ub::launch<Bc7>(mode, in, index, n, out, err, stream);
}

// Transcode the n blocks in[0..n) of any modes into the 16-byte rows
// out[0..n) / err[0..n) in one launch of uastc_kernel_tiles<Bc7>, adding its
// warp-rounds to *rounds (an int64 on the card) unless rounds is null; see
// ub::launch_tiles.
extern "C" int uastc_bc7_launch_tiles(const void* in, int n, void* out, void* err, void* rounds, void* stream) {
  return ub::launch_tiles<Bc7>(in, n, out, err, rounds, stream);
}

// Warps of uastc_kernel_tiles<Bc7> resident on one SM into *warps.
extern "C" int uastc_bc7_tiles_warps(int* warps) { return ub::resident_warps_tiles<Bc7>(warps); }

// Warps of mode `mode`'s kernel resident on one SM into *warps; see
// ub::resident_warps.
extern "C" int uastc_bc7_warps(int mode, int* warps) { return ub::resident_warps<Bc7>(mode, warps); }
