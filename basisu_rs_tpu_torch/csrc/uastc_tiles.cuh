// Tile-local mode bucketing, the steps of uastc_kernel_tiles
// (uastc_launch.cuh): a CTA takes one contiguous tile of kTileBlocks blocks,
// groups the tile's block positions by UASTC mode in shared memory, and
// transcodes them in whole warps of one mode.
//
// Each step below is a function of the thread index over the tile's shared
// arrays (TileShared), and threads of one step write disjoint entries, so
// the kernel runs the steps with a barrier between them, and the host tests
// (tests/test_torch_csrc_host.py) build this same source with g++ and run
// each step for every thread in turn.
//
// The bucketing is a stable counting sort over the 20 modes (19 UASTC modes
// and the invalid mode 19) with each mode's run padded to whole warps:
//   1. tile_count: thread g counts each mode in group g, the 32 positions
//      32g..32g+31 (cnt[g][m]), reading their modes as 8 words;
//   2. tile_scan: thread (m, q) turns cnt[g][m] of the 32 groups of chunk q
//      into offsets within the chunk, and the chunk's count into
//      chunk[q][m] (both mode-minor, so that neighbouring threads read
//      neighbouring counts);
//   3. tile_totals: thread m turns chunk[*][m] into offsets, and total[m];
//   4. tile_starts: thread m sums the padded totals of the modes below it
//      into start[m] (start[20]: the padded length of all runs) and marks
//      its run's padding slots empty;
//   5. tile_place: thread g writes each of its positions, in order, to slot
//      start[m] + chunk[q][m] + cnt[g][m] of its mode m, counting on.
// Round r (slots 32r..32r+31) then holds blocks of one mode, found by
// tile_round_mode, so a warp that takes round r makes one warp-uniform
// branch on the mode; an empty slot's lane idles through the round.
#pragma once
#include <stdint.h>

#include "uastc_decode.cuh"

namespace ub {

// The tile (T) and the CTA: 2^23 blocks make 2,048 tiles; a tile's shared
// arrays (TileShared, 83 KiB) fit two CTAs of 512 threads on an SM.
constexpr int kTileBlocks = 4096;
constexpr int kTileThreads = 512;
constexpr int kTileCtas = 2;  // CTAs an SM is to hold: the register cap of __launch_bounds__
constexpr int kTileModes = 20;                     // UASTC modes 0..18 and the invalid mode 19
constexpr int kTileGroups = kTileBlocks / 32;      // groups of 32 positions a tile
constexpr int kTileChunks = kTileGroups / 32;      // chunks of 32 groups a tile
constexpr int kTileSlots = kTileBlocks + kTileModes * 32;  // every run padded to whole warps, at most
constexpr uint8_t kNoMode = 0xFF;                  // a position past the tile's last block
constexpr uint16_t kNoSlot = 0xFFFF;               // a padding slot
static_assert(kTileBlocks % 1024 == 0 && kTileBlocks < kNoSlot, "tiles of whole chunks with 16-bit positions");

struct TileShared {
  alignas(16) uint32_t rows[4 * kTileBlocks];  // the tile's blocks, then their output rows in place
  uint16_t slots[kTileSlots];                  // tile positions grouped by mode, runs padded with kNoSlot
  uint16_t cnt[kTileGroups * kTileModes];      // [g * kTileModes + m]: count of mode m in group g, then offset
  uint16_t chunk[kTileChunks * kTileModes];    // [q * kTileModes + m]: count of mode m in chunk q, then offset
  int32_t total[kTileModes];                   // blocks of each mode in the tile
  int32_t start[kTileModes + 1];               // first slot of each mode's run; start[20]: all runs' slots
  alignas(16) uint8_t modes[kTileBlocks];      // each position's mode (kNoMode past the end), then its err flag
};

UB_FN int32_t pad32(int32_t x) { return (x + 31) & ~31; }

// The UASTC mode (0..18, 19 invalid) of the block whose first word is w0,
// as ops/dispatch.py block_modes reads it.
UB_FN uint8_t tile_mode(uint32_t w0) { return UB_LDG(MODE_LUT + (w0 & 0x7Fu)); }

// The modes of group g's 32 positions, four to a word (a lane's byte loads
// would meet 8 lanes in a bank).
UB_FN void group_modes(const TileShared& s, int g, uint32_t (&w)[8]) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(s.modes + 32 * g);
  for (int k = 0; k < 8; ++k) w[k] = q[k];
}

UB_FN int group_mode(const uint32_t (&w)[8], int j) { return (w[j >> 2] >> (8 * (j & 3))) & 0xFFu; }

// Step 1 (threads g < kTileGroups): cnt[g][m] of every mode m.
UB_FN void tile_count(int tid, int nthreads, TileShared& s) {
  for (int g = tid; g < kTileGroups; g += nthreads) {
    for (int m = 0; m < kTileModes; ++m) s.cnt[g * kTileModes + m] = 0;
    uint32_t w[8];
    group_modes(s, g, w);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int m = group_mode(w, j);
      if (m != kNoMode) ++s.cnt[g * kTileModes + m];
    }
  }
}

// Step 2 (threads (m, q) < kTileModes * kTileChunks): cnt[g][m] becomes the
// count of mode m in chunk q's groups before g; chunk[q][m] the chunk's.
UB_FN void tile_scan(int tid, int nthreads, TileShared& s) {
  for (int i = tid; i < kTileModes * kTileChunks; i += nthreads) {
    const int m = i % kTileModes, q = i / kTileModes;
    int32_t sum = 0;
#pragma unroll 8
    for (int g = 32 * q; g < 32 * q + 32; ++g) {
      const int32_t c = s.cnt[g * kTileModes + m];
      s.cnt[g * kTileModes + m] = static_cast<uint16_t>(sum);
      sum += c;
    }
    s.chunk[i] = static_cast<uint16_t>(sum);
  }
}

// Step 3 (threads m < kTileModes): chunk[q][m] becomes the count of mode m
// in the chunks before q; total[m] the count over the tile.
UB_FN void tile_totals(int tid, int nthreads, TileShared& s) {
  for (int m = tid; m < kTileModes; m += nthreads) {
    int32_t sum = 0;
    for (int q = 0; q < kTileChunks; ++q) {
      const int32_t c = s.chunk[q * kTileModes + m];
      s.chunk[q * kTileModes + m] = static_cast<uint16_t>(sum);
      sum += c;
    }
    s.total[m] = sum;
  }
}

// Step 4 (threads m <= kTileModes): start[m], and the padding of run m.
UB_FN void tile_starts(int tid, int nthreads, TileShared& s) {
  for (int m = tid; m <= kTileModes; m += nthreads) {
    int32_t a = 0;
    for (int k = 0; k < m; ++k) a += pad32(s.total[k]);
    s.start[m] = a;
    if (m < kTileModes)
      for (int k = a + s.total[m]; k < a + pad32(s.total[m]); ++k) s.slots[k] = kNoSlot;
  }
}

// Step 5 (threads g < kTileGroups): each position of group g, in order, to
// the next slot of its mode's run.
UB_FN void tile_place(int tid, int nthreads, TileShared& s) {
  for (int g = tid; g < kTileGroups; g += nthreads) {
    uint32_t w[8];
    group_modes(s, g, w);
    const int q = g >> 5;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int m = group_mode(w, j);
      if (m != kNoMode)
        s.slots[s.start[m] + s.chunk[q * kTileModes + m] + s.cnt[g * kTileModes + m]++] =
            static_cast<uint16_t>(32 * g + j);
    }
  }
}

// Warp-rounds of the tile: whole warps over the padded runs.
UB_FN int32_t tile_rounds(const TileShared& s) { return s.start[kTileModes] >> 5; }

// The mode of round r < tile_rounds(s): the last mode whose run starts at or
// before slot 32r (an empty run starts where the next one does).
UB_FN int tile_round_mode(const TileShared& s, int32_t r) {
  int m = 0;
  for (int k = 1; k < kTileModes; ++k) m = s.start[k] <= 32 * r ? k : m;
  return m;
}

// Op<m>::run for m = 0..18, which every Op declares with 16-byte rows; the
// invalid mode 19 gives a zero row and err, as the dispatch writes it.
template <template <int> class Op>
UB_FN bool run_mode(int m, const uint32_t (&l)[4], uint32_t (&o)[4]) {
  switch (m) {
    case 0: return Op<0>::run(l, o);
    case 1: return Op<1>::run(l, o);
    case 2: return Op<2>::run(l, o);
    case 3: return Op<3>::run(l, o);
    case 4: return Op<4>::run(l, o);
    case 5: return Op<5>::run(l, o);
    case 6: return Op<6>::run(l, o);
    case 7: return Op<7>::run(l, o);
    case 8: return Op<8>::run(l, o);
    case 9: return Op<9>::run(l, o);
    case 10: return Op<10>::run(l, o);
    case 11: return Op<11>::run(l, o);
    case 12: return Op<12>::run(l, o);
    case 13: return Op<13>::run(l, o);
    case 14: return Op<14>::run(l, o);
    case 15: return Op<15>::run(l, o);
    case 16: return Op<16>::run(l, o);
    case 17: return Op<17>::run(l, o);
    case 18: return Op<18>::run(l, o);
    default:
      o[0] = o[1] = o[2] = o[3] = 0u;
      return true;
  }
}

// Lane `lane` of round r: the block in its slot, transcoded as mode m (the
// round's), its output row written over its input row and its err flag over
// its mode.  A padding slot's lane does nothing.
template <template <int> class Op>
UB_FN void tile_lane(TileShared& s, int m, int32_t r, int lane) {
  const uint16_t p = s.slots[32 * r + lane];
  if (p == kNoSlot) return;
  uint32_t* row = s.rows + 4 * p;
#if defined(__CUDACC__)
  const uint4 v = *reinterpret_cast<const uint4*>(row);  // one 16-byte shared load
  const uint32_t l[4] = {v.x, v.y, v.z, v.w};
#else
  const uint32_t l[4] = {row[0], row[1], row[2], row[3]};
#endif
  uint32_t o[4];
  s.modes[p] = run_mode<Op>(m, l, o) ? 1 : 0;
#if defined(__CUDACC__)
  *reinterpret_cast<uint4*>(row) = make_uint4(o[0], o[1], o[2], o[3]);
#else
  for (int k = 0; k < 4; ++k) row[k] = o[k];
#endif
}

}  // namespace ub
