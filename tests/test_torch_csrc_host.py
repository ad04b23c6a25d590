"""PyTorch port: the kernels' own per-block sources, compiled for the host.

`basisu_rs_tpu_torch/csrc/uastc_{bc7,astc,rgba,etc}.cuh` (over the shared
`uastc_decode.cuh`), `csrc/etc1s.cuh` and `csrc/uastc_bc7_stages.cuh` hold
the per-block logic of K1-K9 and T1 behind a macro shim, so g++ builds the
exact code the CUDA kernels run (the probe P evaluates `ub::fl_div255` of
`uastc_decode.cuh`).  This test builds them into a temporary directory,
calls them over ctypes and holds every mode, ETC1S kind and (mode, stage)
against the plain PyTorch versions (tolerance 0): shift, signedness and
table-index faults show here without a card.  Exhaustive pins cover the
small helpers: the per-texel weight read of every (mode, pattern, texel,
plane), K2's weight stream and invert mask of every (mode, pattern), K1's
word-level weight field and invert flags of every (word mode, pattern)
against the per-weight form it replaced, remove_zero at every bit
position, K4's RGB key tables, the EAC selector search, K5's alpha-key lookup and bit
scans, the ETC1 selector forms and selector word, the subblock average and
the bias rule; K5's alpha range is held at its edges (one key, the extreme
keys).  The package never loads this build; it skips only when g++ is
absent.  The last tests check the ptxas report and SASS count parsers of
`ops/build.py` and the SASS split of `tools/sass_split.py` on canned
output."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.ops import bc7_stages, build, etc1s, fl_div255_probe, kernels
from basisu_rs_tpu_torch.ops.bits import lanes_from_bytes
from basisu_rs_tpu_torch.ops.uastc_decode import decode_weights, subsets_for_texels
from basisu_rs_tpu_torch.tables import (BC7_MODES, LA, MODES, bc7_mode_of, device_tables,
                                        fam_bc7_inv_relpos_packed, family_name)
import oracle_uastc as ou
from torch_cases import bias_reference, eac_reference_selectors, etc1_selector_cases, etc1s_inputs

HOST_ENTRY = r"""
#include <string.h>
#include "etc1s.cuh"
#include "uastc_astc.cuh"
#include "uastc_bc7.cuh"
#include "uastc_bc7_stages.cuh"
#include "uastc_etc.cuh"
#include "uastc_rgba.cuh"
#include "uastc_tiles.cuh"

#include <memory>

template <int M> struct Bc7 {
  static constexpr int kOut = 16;
  static bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_bc7<M>(l, o); }
};
template <int M> struct Astc {
  static constexpr int kOut = 16;
  static bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_astc<M>(l, o); }
};
template <int M> struct Rgba {
  static constexpr int kOut = 64;
  static bool run(const uint32_t (&l)[4], uint32_t (&o)[16]) { return ub::uastc_to_rgba<M>(l, o); }
};
template <int M> struct Etc1 {
  static constexpr int kOut = 8;
  static bool run(const uint32_t (&l)[4], uint32_t (&o)[2]) { return ub::uastc_to_etc1<M>(l, o); }
};
template <int M> struct Etc2 {
  static constexpr int kOut = 16;
  static bool run(const uint32_t (&l)[4], uint32_t (&o)[4]) { return ub::uastc_to_etc2<M>(l, o); }
};

template <class Op>
static void run(const uint8_t* in, long long n, uint8_t* out, uint8_t* err) {
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4], o[Op::kOut / 4];
    memcpy(l, in + 16 * t, 16);
    err[t] = Op::run(l, o) ? 1 : 0;
    memcpy(out + Op::kOut * t, o, Op::kOut);
  }
}

typedef void (*RunFn)(const uint8_t*, long long, uint8_t*, uint8_t*);
#define TABLE(OP) {run<OP<0>>,  run<OP<1>>,  run<OP<2>>,  run<OP<3>>,  run<OP<4>>,  \
                   run<OP<5>>,  run<OP<6>>,  run<OP<7>>,  run<OP<8>>,  run<OP<9>>,  \
                   run<OP<10>>, run<OP<11>>, run<OP<12>>, run<OP<13>>, run<OP<14>>, \
                   run<OP<15>>, run<OP<16>>, run<OP<17>>, run<OP<18>>}
static const RunFn kRun[5][19] = {TABLE(Bc7), TABLE(Astc), TABLE(Rgba), TABLE(Etc1), TABLE(Etc2)};

// target: 0 bc7, 1 astc, 2 rgba, 3 etc1, 4 etc2
extern "C" void uastc_host(int target, int mode, const uint8_t* in, long long n, uint8_t* out,
                           uint8_t* err) {
  kRun[target][mode](in, n, out, err);
}

extern "C" float fl_div255_host(int x) { return ub::fl_div255(x); }

// T1: bc7_stage<M, S> over n blocks, as bc7_stage_kernel<M, S> computes each
template <int M, int S>
static void stage_run(const uint8_t* in, long long n, uint32_t* out) {
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4];
    memcpy(l, in + 16 * t, 16);
    out[t] = ub::bc7_stage<M, S>(l);
  }
}
typedef void (*StageFn)(const uint8_t*, long long, uint32_t*);
template <int M, int S>
static StageFn stage_fn() {
  if constexpr (ub::kStageExists<M, S>) return stage_run<M, S>;
  else return nullptr;
}
#define STAGE_ROW(M) \
  {stage_fn<M, 0>(), stage_fn<M, 1>(), stage_fn<M, 2>(), stage_fn<M, 3>(), stage_fn<M, 4>(), stage_fn<M, 5>()}
static const StageFn kStage[19][6] = {STAGE_ROW(0),  STAGE_ROW(1),  STAGE_ROW(2),  STAGE_ROW(3),  STAGE_ROW(4),
                                      STAGE_ROW(5),  STAGE_ROW(6),  STAGE_ROW(7),  STAGE_ROW(8),  STAGE_ROW(9),
                                      STAGE_ROW(10), STAGE_ROW(11), STAGE_ROW(12), STAGE_ROW(13), STAGE_ROW(14),
                                      STAGE_ROW(15), STAGE_ROW(16), STAGE_ROW(17), STAGE_ROW(18)};
// returns 0, or -1 for a pair that is not instantiated
extern "C" int bc7_stage_host(int mode, int stage, const uint8_t* in, long long n, uint32_t* out) {
  if (kStage[mode][stage] == nullptr) return -1;
  kStage[mode][stage](in, n, out);
  return 0;
}

// texel_weight<M> of every (texel, plane) under pattern pat over n blocks:
// out[t][planes * i + p]; returns -1 for mode 8, which has no weights.
template <int M>
static void texel_weights_run(int pat, const uint8_t* in, long long n, uint32_t* out) {
  constexpr int planes = ub::Mode<M>::planes;
  const uint32_t abp = ub::weight_anchors<M>(pat);
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4];
    memcpy(l, in + 16 * t, 16);
    for (int i = 0; i < 16; ++i)
      for (int p = 0; p < planes; ++p) out[16 * planes * t + planes * i + p] = ub::texel_weight<M>(l, abp, i, p);
  }
}
typedef void (*WeightsFn)(int, const uint8_t*, long long, uint32_t*);
template <int M>
static WeightsFn weights_fn() {
  if constexpr (M == 8) return nullptr;
  else return texel_weights_run<M>;
}
static const WeightsFn kWeights[19] = {
    weights_fn<0>(),  weights_fn<1>(),  weights_fn<2>(),  weights_fn<3>(),  weights_fn<4>(),
    weights_fn<5>(),  weights_fn<6>(),  weights_fn<7>(),  weights_fn<8>(),  weights_fn<9>(),
    weights_fn<10>(), weights_fn<11>(), weights_fn<12>(), weights_fn<13>(), weights_fn<14>(),
    weights_fn<15>(), weights_fn<16>(), weights_fn<17>(), weights_fn<18>()};
extern "C" int texel_weights_host(int mode, int pat, const uint8_t* in, long long n, uint32_t* out) {
  if (kWeights[mode] == nullptr) return -1;
  kWeights[mode](pat, in, n, out);
  return 0;
}

// The ETC pieces, batched for the exhaustive pins below.
// EAC selector of every (centre, alpha) in 0..255 for one table and multiplier.
extern "C" void eac_selectors_host(int tbl, int mult, uint8_t* out) {
  for (int center = 0; center < 256; ++center) {
    int32_t T[7];
    ub::eac_thresholds(center, mult, ub::EAC_MOD_PACKED[2 * tbl], ub::EAC_MOD_PACKED[2 * tbl + 1], T);
    const ub::EacLanes lanes = ub::eac_lanes(T);
    for (int a = 0; a < 256; ++a) out[256 * center + a] = static_cast<uint8_t>(ub::eac_selector(a, lanes));
  }
}
// ETC1 wire bits ms | ls << 1 of n (luminance, 3 thresholds) cases, from
// the sign bits of etc1_ms_sign and etc1_ls_sign.
extern "C" void etc1_selectors_host(const int* lum, const int* th, int n, uint8_t* out) {
  for (int k = 0; k < n; ++k) {
    const int32_t t[3] = {th[3 * k], th[3 * k + 1], th[3 * k + 2]};
    out[k] = static_cast<uint8_t>((ub::etc1_ms_sign(lum[k], t) >> 31) | ((ub::etc1_ls_sign(lum[k], t) >> 31) << 1));
  }
}
// etc1_selector_word of n cases of 16 luminances and 4 x 3 quad thresholds.
extern "C" void etc1_selector_words_host(const int* lum, const int* tq, int n, uint32_t* out) {
  for (int k = 0; k < n; ++k) {
    int32_t l[16], t[4][3];
    for (int i = 0; i < 16; ++i) l[i] = lum[16 * k + i];
    for (int q = 0; q < 4; ++q)
      for (int j = 0; j < 3; ++j) t[q][j] = tq[12 * k + 3 * q + j];
    out[k] = ub::etc1_selector_word(l, t);
  }
}

// K2's weight stream of mode M under pattern pat over n blocks (3 words a
// block), and its invert mask: invert_stream<M> of a zero stream with the
// subsets whose bit is set in inv_bits swapped.
template <int M>
static void stream_run(int pat, int inv_bits, const uint8_t* in, long long n, uint32_t* out, uint32_t* inv_out) {
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4], s[4];
    memcpy(l, in + 16 * t, 16);
    ub::weight_stream<M>(l, pat, s);
    memcpy(out + 3 * t, s, 12);
  }
  bool inv[ub::Mode<M>::subsets];
  for (int s = 0; s < ub::Mode<M>::subsets; ++s) inv[s] = (inv_bits >> s) & 1;
  uint32_t m[4] = {0, 0, 0, 0};
  ub::invert_stream<M>(m, inv, pat);
  memcpy(inv_out, m, 12);
}
typedef void (*StreamFn)(int, int, const uint8_t*, long long, uint32_t*, uint32_t*);
template <int M>
static StreamFn stream_fn() {
  if constexpr (M == 8) return nullptr;
  else return stream_run<M>;
}
static const StreamFn kStream[19] = {
    stream_fn<0>(),  stream_fn<1>(),  stream_fn<2>(),  stream_fn<3>(),  stream_fn<4>(),
    stream_fn<5>(),  stream_fn<6>(),  stream_fn<7>(),  stream_fn<8>(),  stream_fn<9>(),
    stream_fn<10>(), stream_fn<11>(), stream_fn<12>(), stream_fn<13>(), stream_fn<14>(),
    stream_fn<15>(), stream_fn<16>(), stream_fn<17>(), stream_fn<18>()};
extern "C" int weight_stream_host(int mode, int pat, int inv_bits, const uint8_t* in, long long n, uint32_t* out,
                                  uint32_t* inv_out) {
  if (kStream[mode] == nullptr) return -1;
  kStream[mode](pat, inv_bits, in, n, out, inv_out);
  return 0;
}

// K1's weight field of word-weights mode M under pattern pat over n blocks:
// bc7_weight_word<M> (the field in two words a block, the invert flag of
// BC7 subset j in bit j of inv), and the per-weight form it replaced, with
// the field at offset 0: texel_weight -> remap_weight -> the invert flag of
// each BC7 subset j >= 1 read by extract_bit_dyn through
// FAM_BC7_INV_RELPOS_PACKED -> the per-texel XOR -> the pre-shifted puts of
// FAM_BC7_WEIGHT_PRESHIFT_PACKED.
template <int M>
static void bc7_weights_run(int pat, const uint8_t* in, long long n, uint32_t* word, uint32_t* word_inv,
                            uint32_t* ref, uint32_t* ref_inv) {
  using C = ub::Mode<M>;
  using B = ub::Bc7Mode<C::bc7>;
  constexpr int wb7 = B::weight_bits, nsub7 = B::subset_count;
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4];
    memcpy(l, in + 16 * t, 16);
    bool inv[3];
    const uint64_t f = ub::bc7_weight_word<M>(l, pat, inv);
    word[2 * t] = static_cast<uint32_t>(f);
    word[2 * t + 1] = static_cast<uint32_t>(f >> 32);
    word_inv[t] = (inv[0] ? 1u : 0u) | (inv[1] ? 2u : 0u) | (inv[2] ? 4u : 0u);

    const uint32_t abp = ub::weight_anchors<M>(pat);
    uint32_t w[16], o[4] = {0, 0, 0, 0}, rinv = 0;
    for (int i = 0; i < 16; ++i) w[i] = ub::remap_weight<C::weight_bits, wb7>(ub::texel_weight<M>(l, abp, i, 0));
    if constexpr (nsub7 == 1) {
      for (int i = 0, ofs = 0; i < 16; ++i) {
        const int bits_i = i == 0 ? wb7 - 1 : wb7;
        ub::put(o, w[i], ofs, bits_i);
        ofs += bits_i;
      }
    } else {
      using F = ub::Family<C::fam>;
      const uint32_t pat_packed = ub::FAM_BC7_PAT_PACKED[F::base + pat];
      const uint32_t inv_packed = ub::FAM_BC7_INV_RELPOS_PACKED[C::inv_base + pat];
      uint32_t inv_mask[3] = {0u, 0u, 0u};
      for (int s = 1; s < nsub7; ++s) {
        const uint32_t entry = (inv_packed >> (8 * (s - 1))) & 0xFFu;
        const int rlo = s == 1 ? C::inv_lo1 : C::inv_lo2, rhi = s == 1 ? C::inv_hi1 : C::inv_hi2;
        const uint32_t bit = ub::extract_bit_dyn(l, (entry & 63u) + C::ofs_weights, C::ofs_weights + rlo,
                                                 C::ofs_weights + rhi + 1);
        const bool sw = (bit & (entry >> 7)) != 0u;
        inv_mask[s] = sw ? ub::mask(wb7) : 0u;
        rinv |= sw ? 1u << s : 0u;
      }
      for (int i = 0; i < 16; ++i) {
        const uint32_t s_i = (pat_packed >> (2 * i)) & 3u;
        w[i] ^= s_i == 1u ? inv_mask[1] : s_i == 2u ? inv_mask[2] : 0u;
      }
      const uint32_t ps_packed = ub::FAM_BC7_WEIGHT_PRESHIFT_PACKED[F::base + pat];
      for (int i = 0; i < 16; ++i) {
        const int mn = (F::bc7_ab_min_packed >> (2 * i)) & 3, mx = (F::bc7_ab_max_packed >> (2 * i)) & 3;
        if (mn == mx) ub::put(o, w[i], wb7 * i - mx, wb7);
        else ub::put(o, w[i] << ((ps_packed >> (2 * i)) & 3u), wb7 * i - mx, wb7 + mx);
      }
    }
    ref[2 * t] = o[0];
    ref[2 * t + 1] = o[1];
    ref_inv[t] = rinv;
  }
}
typedef void (*Bc7WeightsFn)(int, const uint8_t*, long long, uint32_t*, uint32_t*, uint32_t*, uint32_t*);
template <int M>
static Bc7WeightsFn bc7_weights_fn() {
  if constexpr (!ub::kWordWeights<M>) return nullptr;
  else return bc7_weights_run<M>;
}
static const Bc7WeightsFn kBc7Weights[19] = {
    bc7_weights_fn<0>(),  bc7_weights_fn<1>(),  bc7_weights_fn<2>(),  bc7_weights_fn<3>(),  bc7_weights_fn<4>(),
    bc7_weights_fn<5>(),  bc7_weights_fn<6>(),  bc7_weights_fn<7>(),  bc7_weights_fn<8>(),  bc7_weights_fn<9>(),
    bc7_weights_fn<10>(), bc7_weights_fn<11>(), bc7_weights_fn<12>(), bc7_weights_fn<13>(), bc7_weights_fn<14>(),
    bc7_weights_fn<15>(), bc7_weights_fn<16>(), bc7_weights_fn<17>(), bc7_weights_fn<18>()};
// returns -1 for a mode whose weights K1 puts texel by texel
extern "C" int bc7_weights_host(int mode, int pat, const uint8_t* in, long long n, uint32_t* word,
                                uint32_t* word_inv, uint32_t* ref, uint32_t* ref_inv) {
  if (kBc7Weights[mode] == nullptr) return -1;
  kBc7Weights[mode](pat, in, n, word, word_inv, ref, ref_inv);
  return 0;
}
// remove_zero at bit p of n 64-bit values s (bit p 0) and insert_zero of the
// result; insert_zero then remove_zero of n values x (top bit 0); the same
// in 32 bits on the low words, for p < 32.
extern "C" void zero_bits_host(int p, const uint64_t* s, const uint64_t* x, long long n, uint64_t* out) {
  for (long long t = 0; t < n; ++t) {
    const uint64_t r = ub::remove_zero(s[t], p);
    out[6 * t] = r;
    out[6 * t + 1] = ub::insert_zero(r, p);
    out[6 * t + 2] = ub::remove_zero(ub::insert_zero(x[t], p), p);
    if (p < 32) {
      const uint32_t s32 = static_cast<uint32_t>(s[t]), x32 = static_cast<uint32_t>(x[t]) >> 1;
      const uint32_t r32 = ub::remove_zero(s32, p);
      out[6 * t + 3] = r32;
      out[6 * t + 4] = ub::insert_zero(r32, p);
      out[6 * t + 5] = ub::remove_zero(ub::insert_zero(x32, p), p);
    }
  }
}

// K4's RGB key table over n blocks of mode M: per texel its key, the
// (packed quad RGB, luminance) the table gives for it, and the same from
// texel_channels; returns -1 for a mode without a table.
template <int M>
static void rgb_keys_run(const uint8_t* in, long long n, uint32_t* key, uint32_t* tab, uint32_t* lerp) {
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4];
    memcpy(l, in + 16 * t, 16);
    ub::BlockLerp<M> b;
    ub::decode_block<M, 3>(l, b);
    int32_t pat;
    ub::decode_pattern<M>(l, pat);
    uint32_t st[4];
    ub::weight_stream<M>(l, pat, st);
    ub::RgbKeyTable<ub::RgbKeys<M>::count> table;
    ub::fill_rgb_keys<M>(b, table);
    for (int i = 0; i < 16; ++i) {
      const long long r = 16 * t + i;
      key[r] = ub::rgb_key<M>(st, b.sp, i);
      uint32_t rgb;
      int32_t lum;
      table.get(key[r], rgb, lum);
      tab[2 * r] = rgb;
      tab[2 * r + 1] = static_cast<uint32_t>(lum);
      int32_t ch[4];
      ub::texel_channels<M, 3>(l, b, i, ch);
      lerp[2 * r] = ub::pack_quad_rgb(ch[0], ch[1], ch[2]);
      lerp[2 * r + 1] = static_cast<uint32_t>(ub::texel_luminance(ch[0], ch[1], ch[2]));
    }
  }
}
typedef void (*RgbKeysFn)(const uint8_t*, long long, uint32_t*, uint32_t*, uint32_t*);
template <int M>
static RgbKeysFn rgb_keys_fn() {
  if constexpr (!ub::RgbKeys<M>::tabled) return nullptr;
  else return rgb_keys_run<M>;
}
static const RgbKeysFn kRgbKeys[19] = {
    rgb_keys_fn<0>(),  rgb_keys_fn<1>(),  rgb_keys_fn<2>(),  rgb_keys_fn<3>(),  rgb_keys_fn<4>(),
    rgb_keys_fn<5>(),  rgb_keys_fn<6>(),  rgb_keys_fn<7>(),  rgb_keys_fn<8>(),  rgb_keys_fn<9>(),
    rgb_keys_fn<10>(), rgb_keys_fn<11>(), rgb_keys_fn<12>(), rgb_keys_fn<13>(), rgb_keys_fn<14>(),
    rgb_keys_fn<15>(), rgb_keys_fn<16>(), rgb_keys_fn<17>(), rgb_keys_fn<18>()};
extern "C" int rgb_keys_host(int mode, const uint8_t* in, long long n, uint32_t* key, uint32_t* tab,
                             uint32_t* lerp) {
  if (kRgbKeys[mode] == nullptr) return -1;
  kRgbKeys[mode](in, n, key, tab, lerp);
  return 0;
}
// key_selector<NKEYS> of every key k < NKEYS from the table (tab0, tab1).
extern "C" void key_selectors_host(int nkeys, uint32_t tab0, uint32_t tab1, uint8_t* out) {
  const uint32_t tab[2] = {tab0, tab1};
  for (int k = 0; k < nkeys; ++k) {
    uint32_t v = 0;
    if (nkeys == 2) v = ub::key_selector<2>(tab, k);
    else if (nkeys == 4) v = ub::key_selector<4>(tab, k);
    else v = ub::key_selector<8>(tab, k);
    out[k] = static_cast<uint8_t>(v);
  }
}
// low_bit and high_bit of x = 1..n-1.
extern "C" void bit_scans_host(int n, int* low, int* high) {
  for (int x = 1; x < n; ++x) {
    low[x] = ub::low_bit(static_cast<uint32_t>(x));
    high[x] = ub::high_bit(static_cast<uint32_t>(x));
  }
}
// subblock_average(ssum, limit) of ssum = 0..n-1.
extern "C" void subblock_averages_host(int limit, int n, int* out) {
  for (int ssum = 0; ssum < n; ++ssum) out[ssum] = ub::subblock_average(ssum, limit);
}
// apply_bias of v = 0..limit for one (bias, subblock, channel).
extern "C" void apply_bias_host(int bias, int subblock, int channel, int limit, int* out) {
  const uint32_t field = (ub::ETC_BIAS_PACKED[bias] >> (2 * (3 * subblock + channel))) & 3u;
  for (int v = 0; v <= limit; ++v) out[v] = ub::apply_bias(v, static_cast<int32_t>(field), limit);
}

// K6-K9 over n blocks, as etc1s_kernel<KIND> computes each: the codebook
// words gathered through etc1s_word, then the four rows (texel kinds) or
// the ETC1 block.
extern "C" void etc1s_host(int kind, const uint32_t* ep_tab, int n_ep, const uint32_t* sel_tab, int n_sel,
                           const uint16_t* i0, const uint16_t* i1, const uint16_t* i2, const uint16_t* i3,
                           long long n, uint8_t* out) {
  for (long long b = 0; b < n; ++b) {
    const uint32_t ep = ub::etc1s_word(ep_tab, n_ep, i0[b]), sel = ub::etc1s_word(sel_tab, n_sel, i1[b]);
    if (kind == ub::ETC1S_ETC1) {
      uint32_t o[2];
      ub::etc1s_etc1_block(ep, sel, o);
      memcpy(out + 8 * b, o, 8);
      continue;
    }
    const bool pair = kind == ub::ETC1S_RGBA_ALPHA;
    const uint32_t a_ep = pair ? ub::etc1s_word(ep_tab, n_ep, i2[b]) : 0;
    const uint32_t a_sel = pair ? ub::etc1s_word(sel_tab, n_sel, i3[b]) : 0;
    for (int y = 0; y < 4; ++y) {
      uint32_t o[4];
      if (kind == ub::ETC1S_RGBA) ub::etc1s_row<ub::ETC1S_RGBA>(ep, sel, a_ep, a_sel, y, o);
      else if (kind == ub::ETC1S_ALPHA) ub::etc1s_row<ub::ETC1S_ALPHA>(ep, sel, a_ep, a_sel, y, o);
      else ub::etc1s_row<ub::ETC1S_RGBA_ALPHA>(ep, sel, a_ep, a_sel, y, o);
      memcpy(out + 64 * b + 16 * y, o, 16);
    }
  }
}

// uastc_kernel_tiles<Op>'s CTA over one tile, on the host: the load, then
// each bucketing step for every thread in turn (a barrier between steps),
// as the kernel runs them.
static void tile_load(ub::TileShared& s, const uint8_t* in, int count) {
  for (int p = 0; p < ub::kTileBlocks; ++p) {
    uint8_t m = ub::kNoMode;
    if (p < count) {
      memcpy(s.rows + 4 * p, in + 16 * p, 16);
      m = ub::tile_mode(s.rows[4 * p]);
    }
    s.modes[p] = m;
  }
  for (int t = 0; t < ub::kTileThreads; ++t) ub::tile_count(t, ub::kTileThreads, s);
  for (int t = 0; t < ub::kTileThreads; ++t) ub::tile_scan(t, ub::kTileThreads, s);
  for (int t = 0; t < ub::kTileThreads; ++t) ub::tile_totals(t, ub::kTileThreads, s);
  for (int t = 0; t < ub::kTileThreads; ++t) ub::tile_starts(t, ub::kTileThreads, s);
  for (int t = 0; t < ub::kTileThreads; ++t) ub::tile_place(t, ub::kTileThreads, s);
}

extern "C" int tile_blocks_host() { return ub::kTileBlocks; }

// The bucketing of one tile of n <= kTileBlocks blocks: start[0..20], the
// slots of every run and each round's mode; returns the tile's warp-rounds.
extern "C" int tile_bucket_host(const uint8_t* in, int n, int32_t* start, uint16_t* slots, int32_t* round_modes) {
  auto s = std::make_unique<ub::TileShared>();
  tile_load(*s, in, n);
  memcpy(start, s->start, sizeof(s->start));
  memcpy(slots, s->slots, sizeof(uint16_t) * s->start[ub::kTileModes]);
  const int rounds = ub::tile_rounds(*s);
  for (int r = 0; r < rounds; ++r) round_modes[r] = ub::tile_round_mode(*s, r);
  return rounds;
}

// A whole pass of uastc_kernel_tiles<Bc7> over n blocks: each tile in turn,
// its warp-rounds one after another with the lanes of a round in turn, then
// the tile's rows and err bytes stored; returns the warp-rounds.
extern "C" long long tile_pass_host(const uint8_t* in, long long n, uint8_t* out, uint8_t* err) {
  auto s = std::make_unique<ub::TileShared>();
  long long total = 0;
  for (long long base = 0; base < n; base += ub::kTileBlocks) {
    const int count = n - base < ub::kTileBlocks ? static_cast<int>(n - base) : ub::kTileBlocks;
    tile_load(*s, in + 16 * base, count);
    const int rounds = ub::tile_rounds(*s);
    for (int r = 0; r < rounds; ++r)
      for (int lane = 0; lane < 32; ++lane) ub::tile_lane<Bc7>(*s, ub::tile_round_mode(*s, r), r, lane);
    memcpy(out + 16 * base, s->rows, 16 * static_cast<size_t>(count));
    memcpy(err + base, s->modes, count);
    total += rounds;
  }
  return total;
}
"""

TARGET_IDS = {"bc7": 0, "astc": 1, "rgba": 2, "etc1": 3, "etc2": 4}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed; the host build of the kernel sources needs it")
    d = tmp_path_factory.mktemp("uastc_host")
    (d / "host_entry.cpp").write_text(HOST_ENTRY)
    so = d / "libuastc_host.so"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-Wall", "-Wno-unknown-pragmas",
           "-Werror", "-shared", "-fPIC", "-I", str(build.CSRC), "-o", str(so), str(d / "host_entry.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.uastc_host.restype = None
    lib.uastc_host.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.fl_div255_host.restype = ctypes.c_float
    lib.fl_div255_host.argtypes = [ctypes.c_int]
    lib.bc7_stage_host.restype = ctypes.c_int
    lib.bc7_stage_host.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    i, p = ctypes.c_int, ctypes.c_void_p
    for name, args in (("texel_weights_host", [i, i, p, ctypes.c_longlong, p]), ("eac_selectors_host", [i, i, p]),
                       ("key_selectors_host", [i, ctypes.c_uint32, ctypes.c_uint32, p]), ("bit_scans_host", [i, p, p]), ("etc1_selectors_host", [p, p, i, p]),
                       ("subblock_averages_host", [i, i, p]), ("apply_bias_host", [i, i, i, i, p]),
                       ("etc1s_host", [i, p, i, p, i, p, p, p, p, ctypes.c_longlong, p]),
                       ("etc1_selector_words_host", [p, p, i, p])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    lib.texel_weights_host.restype = ctypes.c_int
    lib.weight_stream_host.restype = ctypes.c_int
    lib.weight_stream_host.argtypes = [i, i, i, p, ctypes.c_longlong, p, p]
    lib.rgb_keys_host.restype = ctypes.c_int
    lib.rgb_keys_host.argtypes = [i, p, ctypes.c_longlong, p, p, p]
    lib.bc7_weights_host.restype = ctypes.c_int
    lib.bc7_weights_host.argtypes = [i, i, p, ctypes.c_longlong, p, p, p, p]
    lib.zero_bits_host.restype = None
    lib.zero_bits_host.argtypes = [i, p, p, ctypes.c_longlong, p]
    lib.tile_blocks_host.restype = ctypes.c_int
    lib.tile_blocks_host.argtypes = []
    lib.tile_bucket_host.restype = ctypes.c_int
    lib.tile_bucket_host.argtypes = [p, i, p, p, p]
    lib.tile_pass_host.restype = ctypes.c_longlong
    lib.tile_pass_host.argtypes = [p, ctypes.c_longlong, p, p]
    return lib


def _mode_blocks(golden, mode, n_random):
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(1000 + mode)
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (n_random, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, len(r))
    gold = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


def _check(host_lib, target, mode, blocks):
    out_bytes = kernels.OUT_BYTES[target]
    out = np.zeros((len(blocks), out_bytes), np.uint8)
    err = np.zeros(len(blocks), np.uint8)
    host_lib.uastc_host(TARGET_IDS[target], mode, blocks.ctypes.data, len(blocks), out.ctypes.data, err.ctypes.data)

    t = torch.from_numpy(blocks)
    p_out = torch.zeros(len(blocks), out_bytes, dtype=torch.uint8)
    p_err = torch.zeros(len(blocks), dtype=torch.bool)
    kernels.PLAIN[target](mode, t, None, p_out, p_err)
    bad = np.nonzero(np.any(out != p_out.numpy(), axis=1) | (err.astype(bool) != p_err.numpy()))[0]
    assert bad.size == 0, (
        f"{target} mode {mode}: {bad.size} blocks differ; first {blocks[bad[0]].tolist()}\n"
        f"host {out[bad[0]].tolist()} err {err[bad[0]]}\n"
        f"plain {p_out.numpy()[bad[0]].tolist()} err {bool(p_err[bad[0]])}"
    )


@pytest.mark.parametrize("mode", range(19))
def test_host_build_matches_plain(host_lib, golden, mode):
    _check(host_lib, "bc7", mode, _mode_blocks(golden, mode, 4096))


@pytest.mark.parametrize("target", ["astc", "rgba"])
@pytest.mark.parametrize("mode", range(19))
def test_host_build_astc_rgba_match_plain(host_lib, golden, target, mode):
    _check(host_lib, target, mode, _mode_blocks(golden, mode, 2048))


@pytest.mark.parametrize("target", ["etc1", "etc2"])
@pytest.mark.parametrize("mode", range(19))
def test_host_build_etc_match_plain(host_lib, golden, target, mode):
    _check(host_lib, target, mode, _mode_blocks(golden, mode, 2048))


@pytest.mark.parametrize("mode", [m for m in range(19) if m != 8])
def test_host_texel_weight_every_pattern(host_lib, mode):
    # the per-texel weight read (texel_weight) of every texel and plane under
    # every pattern of the mode, against the plain decode_weights on random
    # blocks whose pattern field holds that pattern
    cfg = MODES[mode]
    rng = np.random.default_rng(2000 + mode)
    blocks = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    lanes = lanes_from_bytes(torch.from_numpy(blocks), 4)
    tables = device_tables("cpu")
    for pat in range(cfg.pattern_count):
        out = np.zeros((len(blocks), cfg.weight_count), np.uint32)
        assert host_lib.texel_weights_host(mode, pat, blocks.ctypes.data, len(blocks), out.ctypes.data) == 0
        plain_w, _ = decode_weights(cfg, lanes, torch.full((len(blocks),), pat, dtype=torch.int64), tables)
        np.testing.assert_array_equal(out, torch.stack(plain_w, dim=1).numpy(), err_msg=f"mode {mode} pattern {pat}")
    assert host_lib.texel_weights_host(8, 0, blocks.ctypes.data, len(blocks), out.ctypes.data) == -1


def _field_int(words) -> int:
    """The little-endian int of a sequence of 32-bit words."""
    return sum(int(w) << (32 * j) for j, w in enumerate(words))


@pytest.mark.parametrize("mode", [m for m in range(19) if m != 8])
def test_host_weight_stream_every_pattern(host_lib, mode):
    # K2's weight stream under every pattern of the mode (so every anchor
    # position): S holds the plain decode_weights' weight k at [k*wb,
    # (k+1)*wb), its 128-bit reversal equals the per-weight form (each
    # weight bit-reversed at [128-(k+1)*wb, 128-k*wb)), and the invert mask
    # of every set of swapped subsets equals the per-texel masks
    cfg = MODES[mode]
    wb, planes, nsub = cfg.weight_bits, cfg.plane_count, cfg.subset_count
    rng = np.random.default_rng(3000 + mode)
    blocks = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    lanes = lanes_from_bytes(torch.from_numpy(blocks), 4)
    tables = device_tables("cpu")
    for pat in range(cfg.pattern_count):
        pats = torch.full((len(blocks),), pat, dtype=torch.int64)
        plain_w, _ = decode_weights(cfg, lanes, pats, tables)
        plain_w = torch.stack(plain_w, dim=1).numpy()
        subsets = [int(s[0]) for s in subsets_for_texels(cfg, pats, tables)] if nsub > 1 else [0] * 16
        for inv_bits in range(1 << nsub):
            out = np.zeros((len(blocks), 3), np.uint32)
            inv = np.zeros(3, np.uint32)
            assert host_lib.weight_stream_host(mode, pat, inv_bits, blocks.ctypes.data, len(blocks), out.ctypes.data,
                                               inv.ctypes.data) == 0
            swapped = [(inv_bits >> subsets[k // planes]) & 1 and cfg.format != LA for k in range(16 * planes)]
            expect_inv = sum(((1 << wb) - 1) << (k * wb) for k in range(16 * planes) if swapped[k])
            assert _field_int(inv) == expect_inv, f"mode {mode} pattern {pat} swapped subsets {inv_bits:b}"
        for t in range(len(blocks)):
            stream = _field_int(out[t])
            expect = sum(int(w) << (k * wb) for k, w in enumerate(plain_w[t]))
            assert stream == expect, f"mode {mode} pattern {pat} block {t}"
            reversed_ = int(f"{stream:0128b}"[::-1], 2)
            per_weight = sum(int(f"{int(w):0{wb}b}"[::-1], 2) << (128 - (k + 1) * wb)
                             for k, w in enumerate(plain_w[t]))
            assert reversed_ == per_weight, f"mode {mode} pattern {pat} block {t}"
    assert host_lib.weight_stream_host(8, 0, 0, blocks.ctypes.data, len(blocks), out.ctypes.data,
                                       inv.ctypes.data) == -1


# K1's modes whose BC7 weight field is one word (one plane, UASTC and BC7
# weight widths equal)
WORD_MODES = [m for m in range(19) if m != 8 and MODES[m].plane_count == 1
              and MODES[m].weight_bits == BC7_MODES[bc7_mode_of(MODES[m])].weight_bits]


def test_word_modes():
    assert WORD_MODES == [0, 1, 2, 3, 4, 7, 9, 10, 15, 16]


@pytest.mark.parametrize("mode", range(19))
def test_host_bc7_weight_word_every_pattern(host_lib, mode):
    # K1's word-level weight field under every pattern of each word mode,
    # on seeded random blocks, against the per-weight form it replaced: the
    # field and every subset's invert flag equal, and every combination of
    # invert flags that the pattern allows is met (a BC7 anchor that is also
    # a UASTC anchor never inverts)
    cfg = MODES[mode]
    rng = np.random.default_rng(4000 + mode)
    n = 256
    word, ref = np.zeros((n, 2), np.uint32), np.zeros((n, 2), np.uint32)
    word_inv, ref_inv = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    if mode not in WORD_MODES:
        assert host_lib.bc7_weights_host(mode, 0, blocks.ctypes.data, n, word.ctypes.data, word_inv.ctypes.data,
                                         ref.ctypes.data, ref_inv.ctypes.data) == -1
        return
    nsub7 = BC7_MODES[bc7_mode_of(cfg)].subset_count
    fam = family_name(cfg)
    for pat in range(cfg.pattern_count):
        blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
        assert host_lib.bc7_weights_host(mode, pat, blocks.ctypes.data, n, word.ctypes.data, word_inv.ctypes.data,
                                         ref.ctypes.data, ref_inv.ctypes.data) == 0
        np.testing.assert_array_equal(word, ref, err_msg=f"mode {mode} pattern {pat}")
        np.testing.assert_array_equal(word_inv, ref_inv, err_msg=f"mode {mode} pattern {pat}")
        field = word[:, 0].astype(np.uint64) | (word[:, 1].astype(np.uint64) << np.uint64(32))
        assert not (field >> np.uint64(16 * cfg.weight_bits - nsub7)).any(), f"mode {mode}: bits past the field"
        allowed = {0}
        for j in range(1, nsub7):
            entry = int(fam_bc7_inv_relpos_packed(fam, cfg.weight_bits)[pat]) >> (8 * (j - 1))
            if entry & 0x80:  # the anchor's MSB is a stored bit
                allowed |= {a | (1 << j) for a in allowed}
        assert set(word_inv.tolist()) == allowed, f"mode {mode} pattern {pat}: invert flags {set(word_inv.tolist())}"


# K1 in one launch (uastc_kernel_tiles<Bc7>, csrc/uastc_tiles.cuh): the
# tile's bucketing, and a whole pass of tiles, built with g++

N_TILE_MODES = 20  # the 19 UASTC modes and the invalid mode 19


def _tile_blocks(mix, n, seed):
    """n random blocks (random pattern fields included) whose first bytes
    give the mix's modes: one mode; every mode, invalid included, at random;
    or runs of one mode 1-97 blocks long.  Returns (blocks, modes)."""
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(seed)
    if mix == "one_mode":
        modes = np.full(n, 7)
    elif mix == "all_modes":
        modes = rng.integers(0, N_TILE_MODES, n)
        modes[: min(n, N_TILE_MODES)] = rng.permutation(N_TILE_MODES)[: min(n, N_TILE_MODES)]
    else:
        modes = np.repeat(rng.integers(0, N_TILE_MODES, n), rng.integers(1, 98, n))[:n]
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    codes = [np.array([b for b in range(256) if lut[b & 0x7F] == m], np.uint8) for m in range(N_TILE_MODES)]
    blocks[:, 0] = [rng.choice(codes[m]) for m in modes]
    return blocks, modes


@pytest.mark.parametrize("mix", ["one_mode", "all_modes", "runs"])
@pytest.mark.parametrize("size", ["1", "31", "32", "33", "T-1", "T"])
def test_host_tile_bucketing_is_a_stable_padded_grouping(host_lib, size, mix):
    # the four steps over one tile, each run for every thread in turn: each
    # mode's positions in tile order, its run padded with empty slots to a
    # multiple of 32 and starting where the last one ended, and every round
    # given the mode of its run
    t = host_lib.tile_blocks_host()
    n = {"T-1": t - 1, "T": t}.get(size) or int(size)
    blocks, modes = _tile_blocks(mix, n, 6000 + n)
    want_start, want_slots = [], []
    for m in range(N_TILE_MODES):
        want_start.append(len(want_slots))
        run = np.flatnonzero(modes == m).tolist()
        want_slots += run + [0xFFFF] * (-len(run) % 32)
    want_start.append(len(want_slots))
    start = np.zeros(N_TILE_MODES + 1, np.int32)
    slots = np.zeros(t + 32 * N_TILE_MODES, np.uint16)
    round_modes = np.zeros(len(slots) // 32, np.int32)
    rounds = host_lib.tile_bucket_host(np.ascontiguousarray(blocks).ctypes.data, n, start.ctypes.data,
                                       slots.ctypes.data, round_modes.ctypes.data)
    assert start.tolist() == want_start
    assert rounds * 32 == want_start[-1]
    assert slots[:rounds * 32].tolist() == want_slots
    want_rounds = [m for m in range(N_TILE_MODES) for _ in range((want_start[m + 1] - want_start[m]) // 32)]
    assert round_modes[:rounds].tolist() == want_rounds


@pytest.mark.parametrize("n", [1, 33, "T-1", "2T+77"])
def test_host_tile_pass_matches_transcode_blocks(host_lib, golden, n):
    # a whole pass of uastc_kernel_tiles<Bc7> on the host, tile by tile and
    # round by round through the host-built Bc7<M>, against the port's CPU
    # path, byte for byte with the err flags: shuffled golden blocks with
    # random blocks of every mode (the invalid mode and pattern indices
    # out of range included), over a ragged last tile
    from basisu_rs_tpu_torch.ops.dispatch import transcode_blocks

    t = host_lib.tile_blocks_host()
    n = {"T-1": t - 1, "2T+77": 2 * t + 77}.get(n, n)
    rng = np.random.default_rng(7000 + n)
    noise, _ = _tile_blocks("all_modes", n, 7100 + n)
    blocks = np.where(rng.random(n)[:, None] < 0.75, golden["bc7_in"][rng.integers(0, len(golden["bc7_in"]), n)],
                      noise)
    blocks = np.ascontiguousarray(blocks)
    out = np.zeros((n, 16), np.uint8)
    err = np.zeros(n, np.uint8)
    rounds = host_lib.tile_pass_host(blocks.ctypes.data, n, out.ctypes.data, err.ctypes.data)
    want, want_err = transcode_blocks(torch.from_numpy(blocks), "bc7")
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(err.astype(bool), want_err.numpy())
    if n > 1000:  # the mix holds flagged blocks and others
        assert want_err.any() and not want_err.all()
    lut = np_tables()["MODE_LUT"]
    counts = [np.bincount(lut[blocks[a : a + t, 0] & 0x7F], minlength=N_TILE_MODES) for a in range(0, n, t)]
    assert rounds == sum(int(np.sum(-(-c // 32))) for c in counts)  # every tile's padded runs, in whole warps


def test_host_remove_zero_inverts_insert_zero(host_lib):
    # remove_zero at every bit position of 64- and 32-bit words: equal to
    # (s & mask(p)) | ((s >> 1) & ~mask(p)) where bit p of s is 0, undone by
    # insert_zero, and undoing insert_zero where the top bit is 0
    rng = np.random.default_rng(5000)
    n = 512
    for p in range(64):
        s = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False) & ~np.uint64(1 << p)
        x = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        out = np.zeros((n, 6), np.uint64)
        host_lib.zero_bits_host(p, s.ctypes.data, x.ctypes.data, n, out.ctypes.data)
        for t in range(n):
            low = (1 << p) - 1
            assert int(out[t, 0]) == (int(s[t]) & low) | ((int(s[t]) >> 1) & ~low), f"p {p} s {int(s[t]):#x}"
        np.testing.assert_array_equal(out[:, 1], s, err_msg=f"p {p}")
        np.testing.assert_array_equal(out[:, 2], x, err_msg=f"p {p}")
        if p < 32:
            s32, x32 = s & np.uint64(0xFFFFFFFF), (x & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
            low = np.uint64((1 << p) - 1)
            np.testing.assert_array_equal(out[:, 3], (s32 & low) | ((s32 >> np.uint64(1)) & ~low & np.uint64(0xFFFFFFFF)),
                                          err_msg=f"32-bit p {p}")
            np.testing.assert_array_equal(out[:, 4], s32, err_msg=f"32-bit p {p}")
            np.testing.assert_array_equal(out[:, 5], x32, err_msg=f"32-bit p {p}")


@pytest.mark.parametrize("mode", range(19))
def test_host_rgb_key_table(host_lib, golden, mode):
    # K4's RGB key table, in the modes that have one: every texel's entry
    # (packed quad RGB, luminance) equals texel_channels on that texel and
    # the plain RGBA version's texel; every key is met
    blocks = _mode_blocks(golden, mode, 2048)
    n = len(blocks)
    key = np.zeros((n, 16), np.uint32)
    tab, lerp = np.zeros((n, 16, 2), np.uint32), np.zeros((n, 16, 2), np.uint32)
    rc = host_lib.rgb_keys_host(mode, blocks.ctypes.data, n, key.ctypes.data, tab.ctypes.data, lerp.ctypes.data)
    cfg = MODES[mode]
    nkeys = (1 << 2 * cfg.weight_bits) if cfg.plane_count == 2 else cfg.subset_count << cfg.weight_bits
    if mode == 8 or nkeys > 16:
        assert rc == -1
        return
    assert rc == 0
    np.testing.assert_array_equal(tab, lerp, err_msg=f"mode {mode}")
    rgba = torch.zeros(n, 64, dtype=torch.uint8)
    kernels.PLAIN["rgba"](mode, torch.from_numpy(blocks), None, rgba, torch.zeros(n, dtype=torch.bool))
    ch = rgba.numpy().reshape(n, 16, 4).astype(np.uint32)
    np.testing.assert_array_equal(tab[..., 0], ch[..., 0] | (ch[..., 1] << 10) | (ch[..., 2] << 20))
    np.testing.assert_array_equal(tab[..., 1], ch[..., 0] * 108 + ch[..., 1] * 366 + ch[..., 2] * 38)
    assert set(np.unique(key)) == set(range(nkeys)), f"mode {mode}: keys met {sorted(set(np.unique(key)))}"


def _selector_word_reference(lum, tq):
    """The ETC1 selector word of one block: texel u (raster order) at pixel
    id (u%4)*4 + u//4, its selector the count of its quad's thresholds it
    reaches, through SELECTOR_ID_TO_ETC1 (etc.rs:181-190, 363-393)."""
    word = 0
    for u in range(16):
        th = tq[(u // 8) * 2 + (u % 4) // 2]
        mod_id = ou._SELECTOR_ID_TO_ETC1[int((lum[u] >= th).sum())]
        pid = (u % 4) * 4 + u // 4
        bit = 8 * (1 - pid // 8) + pid % 8
        word |= ((mod_id >> 1) << bit) | ((mod_id & 1) << (bit + 16))
    return word


def test_host_etc1_selector_word(host_lib):
    # the whole selector word (sign bits shifted in by SHF.L.W) against the
    # per-texel reference placement, on seeded luminances around seeded
    # non-decreasing thresholds (ties included) and at their extremes
    rng = np.random.default_rng(7)
    n = 4096
    tq = np.sort(rng.integers(0, 130561, (n, 4, 3)), axis=2).astype(np.int32)
    tq[: n // 4] = np.sort(rng.integers(0, 8, (n // 4, 4, 3)), axis=2)
    lum = rng.integers(0, 130561, (n, 16)).astype(np.int32)
    lum[: n // 4] = rng.integers(0, 9, (n // 4, 16))
    lum[n // 4: n // 2] = np.take_along_axis(tq[n // 4: n // 2].reshape(-1, 12),
                                             rng.integers(0, 12, (n // 4, 16)), axis=1)
    lum[-8:], tq[-8:] = 130560, 130560
    lum, tq = np.ascontiguousarray(lum), np.ascontiguousarray(tq)
    out = np.zeros(n, np.uint32)
    host_lib.etc1_selector_words_host(lum.ctypes.data, tq.ctypes.data, n, out.ctypes.data)
    expect = np.array([_selector_word_reference(lum[k], tq[k]) for k in range(n)], np.uint32)
    np.testing.assert_array_equal(out, expect)


def test_host_fl_div255_exhaustive(host_lib):
    got = np.array([host_lib.fl_div255_host(x) for x in range(256)], np.float32)
    expect = (np.arange(256, dtype=np.float32) / np.float32(255.0)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))


@pytest.mark.parametrize("stage", bc7_stages.STAGES)
@pytest.mark.parametrize("mode", range(19))
def test_host_build_bc7_stages_match_plain(host_lib, golden, mode, stage):
    # csrc/uastc_bc7_stages.cuh (T1) as the kernels run it, against the plain stages
    blocks = _mode_blocks(golden, mode, 1024)
    out = np.zeros(len(blocks), np.uint32)
    rc = host_lib.bc7_stage_host(mode, bc7_stages.STAGES.index(stage), blocks.ctypes.data, len(blocks),
                                 out.ctypes.data)
    if mode not in bc7_stages.STAGE_MODES[stage]:
        assert rc == -1
        return
    assert rc == 0
    expect = bc7_stages.stage_kernel(mode, stage)(torch.from_numpy(blocks)).numpy().view(np.uint32)
    bad = np.nonzero(out != expect)[0]
    assert bad.size == 0, f"mode {mode} {stage}: {bad.size} blocks differ; first {blocks[bad[0]].tolist()}"


def test_host_fl_div255_probe_body(host_lib):
    # the probe's body: equal to its plain version (IEEE x/255) on 0..255,
    # and to the two-roundings formula on 0..65535, what the card must print
    x = np.arange(1 << 16, dtype=np.int32)
    got = np.array([host_lib.fl_div255_host(int(v)) for v in x], np.float32)
    plain = fl_div255_probe.fl_div255(torch.from_numpy(x[:256])).numpy()
    np.testing.assert_array_equal(got[:256].view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), fl_div255_probe.two_roundings_np(x).view(np.int32))


def test_host_eac_selector_exhaustive(host_lib):
    # the C++ folded rank search against min_by_key over every table,
    # multiplier, centre and alpha
    out = np.zeros((256, 256), np.uint8)
    for tbl in range(16):
        for mult in range(16):
            host_lib.eac_selectors_host(tbl, mult, out.ctypes.data)
            np.testing.assert_array_equal(out, eac_reference_selectors(tbl, mult), err_msg=f"table {tbl} mult {mult}")


@pytest.mark.parametrize("nkeys", [2, 4, 8])
def test_host_key_selector_every_key(host_lib, nkeys):
    # K5's alpha-key lookup (one PRMT) of every key, over seeded tables of
    # selector bytes 0..7, against the table byte it names
    rng = np.random.default_rng(nkeys)
    for _ in range(64):
        table = rng.integers(0, 8, 8, dtype=np.uint8)
        words = table.view("<u4")
        out = np.zeros(nkeys, np.uint8)
        host_lib.key_selectors_host(nkeys, int(words[0]), int(words[1]), out.ctypes.data)
        np.testing.assert_array_equal(out, table[:nkeys])


def test_host_bit_scans_exhaustive(host_lib):
    # the lowest and highest present key of a subset, over every 16-bit mask
    n = 1 << 16
    low, high = np.zeros(n, np.int32), np.zeros(n, np.int32)
    host_lib.bit_scans_host(n, low.ctypes.data, high.ctypes.data)
    x = np.arange(1, n)
    np.testing.assert_array_equal(low[1:], np.log2(x & -x).astype(np.int32))
    np.testing.assert_array_equal(high[1:], np.floor(np.log2(x)).astype(np.int32))


@pytest.mark.parametrize("mode", [m for m in range(9, 18)])
def test_host_build_etc2_alpha_key_edges(host_lib, golden, mode):
    # K5's alpha range from the keys present: every weight field 0, every
    # weight field all ones, and one texel apart, so the range is one key or
    # the extreme keys (solid EAC blocks and the min/max ends)
    cfg = MODES[mode]
    base = _mode_blocks(golden, mode, 256)
    first = cfg.field_offsets["weights"]
    cases = []
    for fill, odd in ((0, None), (1, None), (0, 5), (1, 11)):
        b = base.copy()
        bits = np.unpackbits(b, axis=1, bitorder="little")
        bits[:, first:] = fill
        if odd is not None:
            bits[:, first + odd * cfg.weight_bits * cfg.plane_count] ^= 1
        cases.append(np.packbits(bits, axis=1, bitorder="little"))
    _check(host_lib, "etc2", mode, np.ascontiguousarray(np.concatenate(cases)))


def test_host_etc1_selector_forms(host_lib):
    lum, th, expected = etc1_selector_cases()
    out = np.zeros(len(lum), np.uint8)
    host_lib.etc1_selectors_host(lum.ctypes.data, th.ctypes.data, len(lum), out.ctypes.data)
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("limit", [15, 31])
def test_host_subblock_average_exhaustive(host_lib, limit):
    out = np.zeros(2041, np.int32)
    host_lib.subblock_averages_host(limit, 2041, out.ctypes.data)
    np.testing.assert_array_equal(out, (np.arange(2041) * limit + 1020) // 2040)


@pytest.mark.parametrize("limit", [15, 31])
def test_host_bias_rule_exhaustive(host_lib, limit):
    out = np.zeros(limit + 1, np.int32)
    for bias in range(32):
        for sb in range(2):
            for c in range(3):
                host_lib.apply_bias_host(bias, sb, c, limit, out.ctypes.data)
                np.testing.assert_array_equal(out, bias_reference(bias, limit, sb, c),
                                              err_msg=f"bias {bias} subblock {sb} channel {c}")


@pytest.mark.parametrize("kind", etc1s.KINDS)
@pytest.mark.parametrize("size", [(1, 1, 64, 20), (200, 150, 1000, 21), (2048, 2048, 600, 22), (65535, 65535, 300, 23)],
                         ids=lambda s: f"E{s[0]}-S{s[1]}")
def test_host_build_etc1s_matches_plain(host_lib, kind, size):
    # csrc/etc1s.cuh, as the kernels run it, against the plain K6-K9
    endpoints, selectors, idx = etc1s_inputs(*size)
    ep_words = etc1s.pack_endpoints(endpoints)
    sel_words = etc1s.selector_wire_words(selectors) if kind == "etc1" else etc1s.pack_selectors(selectors)
    streams = idx[: len(etc1s.INDEX_BOOKS[kind])]
    n = len(streams[0])
    out = np.zeros((n, etc1s.OUT_BYTES[kind]), np.uint8)
    ptrs = [a.ctypes.data for a in streams] + [None] * (4 - len(streams))
    host_lib.etc1s_host(etc1s.KINDS.index(kind), ep_words.ctypes.data, len(ep_words), sel_words.ctypes.data,
                        len(sel_words), *ptrs, n, out.ctypes.data)
    ep_tab, sel_tab = etc1s.codebook_tensor(ep_words, "cpu"), etc1s.codebook_tensor(sel_words, "cpu")
    expect = etc1s.etc1s_kernel(kind)(ep_tab, sel_tab, *[torch.from_numpy(a) for a in streams])
    bad = np.nonzero(np.any(out != expect.numpy(), axis=1))[0]
    assert bad.size == 0, f"{kind}: {bad.size}/{n} blocks differ; first {bad[0]}: host {out[bad[0]].tolist()} " \
                          f"plain {expect.numpy()[bad[0]].tolist()}"


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2ub12uastc_kernelIN12_GLOBAL__N_13Bc7ILi2EEEEEvPK5uint4PKxiPS5_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12uastc_kernelIN12_GLOBAL__N_13Bc7ILi2EEEEEvPK5uint4PKxiPS5_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ub12uastc_kernelIN12_GLOBAL__N_14AstcILi17EEEEEvPK5uint4PKxiPS5_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12uastc_kernelIN12_GLOBAL__N_14AstcILi17EEEEEvPK5uint4PKxiPS5_Ph
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ub12uastc_kernelIN12_GLOBAL__N_14RgbaILi9EEEEEvPK5uint4PKxiPS5_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12uastc_kernelIN12_GLOBAL__N_14RgbaILi9EEEEEvPK5uint4PKxiPS5_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ub12uastc_kernelIN12_GLOBAL__N_14Etc1ILi11EEEEEvPK5uint4PKxiPvPh' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12uastc_kernelIN12_GLOBAL__N_14Etc1ILi11EEEEEvPK5uint4PKxiPvPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ub12uastc_kernelIN12_GLOBAL__N_14Etc2ILi15EEEEEvPK5uint4PKxiPvPh' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12uastc_kernelIN12_GLOBAL__N_14Etc2ILi15EEEEEvPK5uint4PKxiPvPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ub12etc1s_kernelILi2EEEvPKjjS2_jPKtS4_S4_S4_iPv' for 'sm_90a'
ptxas info    : Function properties for _ZN2ub12etc1s_kernelILi2EEEvPKjjS2_jPKtS4_S4_S4_iPv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 416 bytes cmem[0]
"""


def test_ptxas_report_parser():
    assert build.parse_ptxas(PTXAS_LOG) == {
        ("bc7", 2): {"registers": 48, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("astc", 17): {"registers": 40, "stack": 8, "spill_stores": 4, "spill_loads": 4},
        ("rgba", 9): {"registers": 64, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("etc1", 11): {"registers": 56, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("etc2", 15): {"registers": 72, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("etc1s", "rgba_alpha"): {"registers": 30, "stack": 0, "spill_stores": 0, "spill_loads": 0},
    }


SASS_DUMP = """\

Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN2ub12uastc_kernelIN12_GLOBAL__N_14RgbaILi9EEEEEvPK5uint4PKxiPvPh
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                           /* 0x0000000000007919 */
                                                                                /* 0x000e220000002100 */
        /*0020*/              @!P0 EXIT ;                                       /* 0x000000000000894d */
        /*0030*/                   BRA 0x30;                                    /* 0xfffffffc00fc7947 */
        /*0040*/                   NOP;                                         /* 0x0000000000007918 */
		..........

		Function : _ZN2ub12etc1s_kernelILi2EEEvPKjjS2_jPKtS4_S4_S4_iPv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                       /* 0x00000a0000017a02 */
		Function : _Z9unrelatedv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                       /* 0x00000a0000017a02 */
"""


def test_sass_count_parser():
    # phase 2's static instruction count a kernel: NOP padding left out,
    # predicated instructions and the closing self-branch counted
    assert build.parse_sass(SASS_DUMP.splitlines()) == {("rgba", 9): 4, ("etc1s", "rgba_alpha"): 1}


def _source_line(name: str, text: str) -> int:
    """The 1-based line of csrc/name that holds text."""
    lines = (build.CSRC / name).read_text().splitlines()
    return next(i for i, line in enumerate(lines, 1) if text in line)


@pytest.mark.parametrize("target, frames, part", [
    ("astc", [("uastc_decode.cuh", "uint32_t val = (w < 4 ? l[w] : 0u) >> b;"), ("uastc_astc.cuh", "o[3] |= brev(st[0]);")], "weights"),
    ("astc", [("uastc_astc.cuh", "decode_endpoint_digits<M>(l, tq, bits);")], "decode"),
    ("astc", [("uastc_astc.cuh", "const uint32_t packed = quints ?")], "encode"),
    ("astc", [("uastc_launch.cuh", "err[row] = e ? 1 : 0;")], "launch"),
    ("etc1", [("uastc_etc.cuh", "w = funnel_shl(")], "emit"),
    ("etc1", [("uastc_etc.cuh", "return v == 0 ?"), ("uastc_etc.cuh", "c[sb][ch] = has_bias")], "encode"),
    ("etc1", [("uastc_rgba.cuh", "b.abp = weight_anchors<M>(pat);"), ("uastc_etc.cuh", "fill_rgb_keys<M>(b, t);")],
     "decode"),
    ("bc7", [("uastc_decode.cuh", "uint32_t val = (w < 4 ? l[w] : 0u) >> b;"),
             ("uastc_bc7.cuh", "decode_endpoints<M>(l, ep);")], "decode"),
    ("bc7", [("uastc_decode.cuh", "v = insert_zero(v, wb - 1);"), ("uastc_bc7.cuh", "weight_stream<M>(l, pat, st);"),
             ("uastc_bc7.cuh", "wfield = bc7_weight_word<M>(l, pat, inv);")], "weight decode"),
    ("bc7", [("uastc_bc7.cuh", "inv[1] = ((s >> (wb * a1"), ("uastc_bc7.cuh", "wfield = bc7_weight_word<M>(l, pat, inv);")],
     "permute/invert"),
    ("bc7", [("uastc_bc7.cuh", "lo[s][c] = inv[s] ? b : a;")], "permute/invert"),
    ("bc7", [("uastc_bc7.cuh", "unique_pbits<cc, B::color_bits>(lo[j], hi[j], pb_lo[j], pb_hi[j]);")], "p-bits"),
    ("bc7", [("uastc_bc7.cuh", "put(o, static_cast<uint32_t>(lo[j][c]) | (static_cast<uint32_t>(hi[j][c]) << bits)")],
     "endpoint emit"),
    ("bc7", [("uastc_decode.cuh", "return s - ((s >> 1)"), ("uastc_bc7.cuh", "return remove_zero(s, wb - 1);")],
     "weight emit"),
    ("bc7", [("uastc_bc7.cuh", "put64(o, wfield, ofs, 16 * wb7 - nsub7);")], "weight emit"),
])
def test_sass_split_parts(target, frames, part):
    # tools/sass_split.py on nvdisasm --print-line-info-inline text: a
    # chain of frames (one //## line a frame, innermost first) names the
    # part of the instructions below it; NOPs are left out
    from basisu_rs_tpu_torch.tools import sass_split

    chain = [f'\t//## File "/build/csrc/{f}", line {_source_line(f, t)}' for f, t in frames]
    text = chain + ["        /*0010*/                   IMAD R2, R2, 0x100, R3 ;",
                    "        /*0020*/               @P0 EXIT ;", "        /*0030*/                   NOP;"]
    parts = sass_split.split(sass_split.Source(build.CSRC), target, text)
    assert dict(parts) == {part: {"IMAD": 1, "EXIT": 1}}


def test_sass_split_functions(tmp_path):
    # the function spans the split reads off a source: templates, structs
    # and one-line functions; namespaces and tables are not functions
    src = tmp_path / "x.cuh"
    src.write_text("namespace ub {\n"
                   "UB_TABLE uint8_t T[2] = {\n  1, 2\n};\n"
                   "template <int M>\n"
                   "UB_FN int32_t f(int32_t a) {\n  if (a) {\n    return 1;\n  }\n  return 0;\n}\n"
                   "struct S {\n  int32_t a;\n};\n"
                   "UB_FN int32_t g(int32_t a) { return a; }\n"
                   "}  // namespace ub\n")
    from basisu_rs_tpu_torch.tools import sass_split

    assert sass_split.functions(src) == [("f", 5, 11), ("S", 12, 14), ("g", 15, 15)]


def test_csrc_ab_split_functions():
    # tools/csrc_ab.py cuts nvdisasm output into one text a UASTC kernel,
    # each from its .section line; other functions are dropped
    from basisu_rs_tpu_torch.tools import csrc_ab

    text = ["\t.section\t.text._ZN2ub12uastc_kernelIN12_GLOBAL__N_14AstcILi17EEEEEvPK5uint4PKxiPvPh,\"ax\",@progbits\n",
            "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n",
            "\t.section\t.text._Z9unrelatedv,\"ax\",@progbits\n",
            "        /*0000*/                   EXIT ;\n",
            "\t.section\t.text._ZN2ub12uastc_kernelIN12_GLOBAL__N_14Etc1ILi3EEEEEvPK5uint4PKxiPvPh,\"ax\",@progbits\n",
            "        /*0000*/                   EXIT ;\n"]
    parts = csrc_ab.split_functions(text)
    assert sorted(parts) == [("astc", 17), ("etc1", 3)]
    assert parts[("astc", 17)] == text[:2] and parts[("etc1", 3)] == text[4:]
