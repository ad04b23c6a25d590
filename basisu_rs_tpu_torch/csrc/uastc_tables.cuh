// Generated by `python -m basisu_rs_tpu_torch.gen_header` from the numpy
// tables in basisu_rs_tpu_torch/tables/. Do not edit by hand.
#pragma once
#include <stdint.h>

#ifndef UB_TABLE
#error "include uastc_decode.cuh, which defines UB_TABLE"
#endif

namespace ub {

constexpr int INVALID_MODE = 19;
constexpr int FORMAT_RGB = 0, FORMAT_RGBA = 1, FORMAT_LA = 2;
constexpr int MODE8_RGBA_OFFSET = 5, MODE8_ETC1_FLAGS_OFFSET = 37;
constexpr int FAM_NONE = -1, FAM_2 = 0, FAM_3 = 1, FAM_23 = 2, FAM_M1 = 3;

// UASTC modes (ModeCfg + field offsets; bc7 = UASTC_TO_BC7_MODES[id],
// astc_block_mode = UASTC_TO_ASTC_BLOCK_MODE_13[id]).
template <int M> struct Mode;
template <> struct Mode<0> {
  static constexpr int id = 0;
  static constexpr int code_size = 4;
  static constexpr int range = 19;
  static constexpr int format = 0;
  static constexpr int weight_bits = 4;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 6;
  static constexpr int ofs_trans_flags = 4;
  static constexpr int ofs_compsel = 19;
  static constexpr int ofs_pattern = 19;
  static constexpr int ofs_endpoints = 19;
  static constexpr int ofs_weights = 65;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 578;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<1> {
  static constexpr int id = 1;
  static constexpr int code_size = 6;
  static constexpr int range = 20;
  static constexpr int format = 0;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 6;
  static constexpr int ofs_trans_flags = 6;
  static constexpr int ofs_compsel = 21;
  static constexpr int ofs_pattern = 21;
  static constexpr int ofs_endpoints = 21;
  static constexpr int ofs_weights = 69;
  static constexpr int bc7 = 3;
  static constexpr int astc_block_mode = 66;
  static constexpr int fam = 3;
  static constexpr bool multi = false;
  static constexpr int inv_base = 0;
  static constexpr int inv_lo1 = 30;
  static constexpr int inv_hi1 = 30;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<2> {
  static constexpr int id = 2;
  static constexpr int code_size = 5;
  static constexpr int range = 8;
  static constexpr int format = 0;
  static constexpr int weight_bits = 3;
  static constexpr int planes = 1;
  static constexpr int subsets = 2;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 5;
  static constexpr int pattern_count = 30;
  static constexpr int endpoint_count = 12;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 25;
  static constexpr int ofs_weights = 73;
  static constexpr int bc7 = 1;
  static constexpr int astc_block_mode = 2131;
  static constexpr int fam = 0;
  static constexpr bool multi = true;
  static constexpr int inv_base = 1;
  static constexpr int inv_lo1 = 6;
  static constexpr int inv_hi1 = 45;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<3> {
  static constexpr int id = 3;
  static constexpr int code_size = 5;
  static constexpr int range = 7;
  static constexpr int format = 0;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 3;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 4;
  static constexpr int pattern_count = 11;
  static constexpr int endpoint_count = 18;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 24;
  static constexpr int ofs_weights = 89;
  static constexpr int bc7 = 2;
  static constexpr int astc_block_mode = 4162;
  static constexpr int fam = 1;
  static constexpr bool multi = true;
  static constexpr int inv_base = 31;
  static constexpr int inv_lo1 = 5;
  static constexpr int inv_hi1 = 18;
  static constexpr int inv_lo2 = 18;
  static constexpr int inv_hi2 = 28;
};
template <> struct Mode<4> {
  static constexpr int id = 4;
  static constexpr int code_size = 5;
  static constexpr int range = 12;
  static constexpr int format = 0;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 2;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 5;
  static constexpr int pattern_count = 30;
  static constexpr int endpoint_count = 12;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 25;
  static constexpr int ofs_weights = 89;
  static constexpr int bc7 = 3;
  static constexpr int astc_block_mode = 2114;
  static constexpr int fam = 0;
  static constexpr bool multi = true;
  static constexpr int inv_base = 42;
  static constexpr int inv_lo1 = 3;
  static constexpr int inv_hi1 = 29;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<5> {
  static constexpr int id = 5;
  static constexpr int code_size = 5;
  static constexpr int range = 20;
  static constexpr int format = 0;
  static constexpr int weight_bits = 3;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 6;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 20;
  static constexpr int ofs_weights = 68;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 83;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<6> {
  static constexpr int id = 6;
  static constexpr int code_size = 5;
  static constexpr int range = 18;
  static constexpr int format = 0;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 2;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 2;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 6;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 22;
  static constexpr int ofs_endpoints = 22;
  static constexpr int ofs_weights = 66;
  static constexpr int bc7 = 5;
  static constexpr int astc_block_mode = 1090;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<7> {
  static constexpr int id = 7;
  static constexpr int code_size = 5;
  static constexpr int range = 12;
  static constexpr int format = 0;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 2;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 5;
  static constexpr int pattern_count = 19;
  static constexpr int endpoint_count = 12;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 25;
  static constexpr int ofs_weights = 89;
  static constexpr int bc7 = 2;
  static constexpr int astc_block_mode = 2114;
  static constexpr int fam = 2;
  static constexpr bool multi = true;
  static constexpr int inv_base = 72;
  static constexpr int inv_lo1 = 5;
  static constexpr int inv_hi1 = 29;
  static constexpr int inv_lo2 = 5;
  static constexpr int inv_hi2 = 29;
};
template <> struct Mode<8> {
  static constexpr int id = 8;
  static constexpr int code_size = 5;
  static constexpr int range = 0;
  static constexpr int format = 1;
  static constexpr int weight_bits = 0;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 5;
  static constexpr int ofs_pattern = 5;
  static constexpr int ofs_endpoints = 5;
  static constexpr int ofs_weights = 13;
  static constexpr int bc7 = 0;
  static constexpr int astc_block_mode = 0;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<9> {
  static constexpr int id = 9;
  static constexpr int code_size = 5;
  static constexpr int range = 8;
  static constexpr int format = 1;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 2;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 5;
  static constexpr int pattern_count = 30;
  static constexpr int endpoint_count = 16;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 28;
  static constexpr int ofs_pattern = 28;
  static constexpr int ofs_endpoints = 33;
  static constexpr int ofs_weights = 97;
  static constexpr int bc7 = 7;
  static constexpr int astc_block_mode = 2114;
  static constexpr int fam = 0;
  static constexpr bool multi = true;
  static constexpr int inv_base = 42;
  static constexpr int inv_lo1 = 3;
  static constexpr int inv_hi1 = 29;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<10> {
  static constexpr int id = 10;
  static constexpr int code_size = 3;
  static constexpr int range = 13;
  static constexpr int format = 1;
  static constexpr int weight_bits = 4;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 3;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 20;
  static constexpr int ofs_weights = 65;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 578;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<11> {
  static constexpr int id = 11;
  static constexpr int code_size = 2;
  static constexpr int range = 13;
  static constexpr int format = 1;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 2;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 2;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 2;
  static constexpr int ofs_compsel = 19;
  static constexpr int ofs_pattern = 21;
  static constexpr int ofs_endpoints = 21;
  static constexpr int ofs_weights = 66;
  static constexpr int bc7 = 5;
  static constexpr int astc_block_mode = 1090;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<12> {
  static constexpr int id = 12;
  static constexpr int code_size = 3;
  static constexpr int range = 19;
  static constexpr int format = 1;
  static constexpr int weight_bits = 3;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 3;
  static constexpr int ofs_compsel = 20;
  static constexpr int ofs_pattern = 20;
  static constexpr int ofs_endpoints = 20;
  static constexpr int ofs_weights = 81;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 83;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<13> {
  static constexpr int id = 13;
  static constexpr int code_size = 5;
  static constexpr int range = 20;
  static constexpr int format = 1;
  static constexpr int weight_bits = 1;
  static constexpr int planes = 2;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 2;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 28;
  static constexpr int ofs_pattern = 30;
  static constexpr int ofs_endpoints = 30;
  static constexpr int ofs_weights = 94;
  static constexpr int bc7 = 5;
  static constexpr int astc_block_mode = 1089;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<14> {
  static constexpr int id = 14;
  static constexpr int code_size = 5;
  static constexpr int range = 20;
  static constexpr int format = 1;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 5;
  static constexpr int ofs_compsel = 28;
  static constexpr int ofs_pattern = 28;
  static constexpr int ofs_endpoints = 28;
  static constexpr int ofs_weights = 92;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 66;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<15> {
  static constexpr int id = 15;
  static constexpr int code_size = 7;
  static constexpr int range = 20;
  static constexpr int format = 2;
  static constexpr int weight_bits = 4;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 4;
  static constexpr int ofs_trans_flags = 7;
  static constexpr int ofs_compsel = 30;
  static constexpr int ofs_pattern = 30;
  static constexpr int ofs_endpoints = 30;
  static constexpr int ofs_weights = 62;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 578;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<16> {
  static constexpr int id = 16;
  static constexpr int code_size = 6;
  static constexpr int range = 20;
  static constexpr int format = 2;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 1;
  static constexpr int subsets = 2;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 5;
  static constexpr int pattern_count = 30;
  static constexpr int endpoint_count = 8;
  static constexpr int ofs_trans_flags = 6;
  static constexpr int ofs_compsel = 29;
  static constexpr int ofs_pattern = 29;
  static constexpr int ofs_endpoints = 34;
  static constexpr int ofs_weights = 98;
  static constexpr int bc7 = 7;
  static constexpr int astc_block_mode = 2114;
  static constexpr int fam = 0;
  static constexpr bool multi = true;
  static constexpr int inv_base = 42;
  static constexpr int inv_lo1 = 3;
  static constexpr int inv_hi1 = 29;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<17> {
  static constexpr int id = 17;
  static constexpr int code_size = 6;
  static constexpr int range = 20;
  static constexpr int format = 2;
  static constexpr int weight_bits = 2;
  static constexpr int planes = 2;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 4;
  static constexpr int ofs_trans_flags = 6;
  static constexpr int ofs_compsel = 29;
  static constexpr int ofs_pattern = 29;
  static constexpr int ofs_endpoints = 29;
  static constexpr int ofs_weights = 61;
  static constexpr int bc7 = 5;
  static constexpr int astc_block_mode = 1090;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};
template <> struct Mode<18> {
  static constexpr int id = 18;
  static constexpr int code_size = 4;
  static constexpr int range = 11;
  static constexpr int format = 0;
  static constexpr int weight_bits = 5;
  static constexpr int planes = 1;
  static constexpr int subsets = 1;
  static constexpr int compsel_bits = 0;
  static constexpr int pattern_bits = 0;
  static constexpr int pattern_count = 1;
  static constexpr int endpoint_count = 6;
  static constexpr int ofs_trans_flags = 4;
  static constexpr int ofs_compsel = 19;
  static constexpr int ofs_pattern = 19;
  static constexpr int ofs_endpoints = 19;
  static constexpr int ofs_weights = 49;
  static constexpr int bc7 = 6;
  static constexpr int astc_block_mode = 595;
  static constexpr int fam = -1;
  static constexpr bool multi = false;
  static constexpr int inv_base = -1;
  static constexpr int inv_lo1 = 0;
  static constexpr int inv_hi1 = 0;
  static constexpr int inv_lo2 = 0;
  static constexpr int inv_hi2 = 0;
};

// BC7_MODES.
template <int B> struct Bc7Mode;
template <> struct Bc7Mode<0> {
  static constexpr int id = 0;
  static constexpr int pat_bits = 4;
  static constexpr int endpoint_count = 18;
  static constexpr int color_bits = 4;
  static constexpr int alpha_bits = 0;
  static constexpr int weight_bits = 3;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 3;
  static constexpr int p_bits = 1;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 3;
};
template <> struct Bc7Mode<1> {
  static constexpr int id = 1;
  static constexpr int pat_bits = 6;
  static constexpr int endpoint_count = 12;
  static constexpr int color_bits = 6;
  static constexpr int alpha_bits = 0;
  static constexpr int weight_bits = 3;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 2;
  static constexpr int p_bits = 0;
  static constexpr int sp_bits = 1;
  static constexpr int channels = 3;
};
template <> struct Bc7Mode<2> {
  static constexpr int id = 2;
  static constexpr int pat_bits = 6;
  static constexpr int endpoint_count = 18;
  static constexpr int color_bits = 5;
  static constexpr int alpha_bits = 0;
  static constexpr int weight_bits = 2;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 3;
  static constexpr int p_bits = 0;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 3;
};
template <> struct Bc7Mode<3> {
  static constexpr int id = 3;
  static constexpr int pat_bits = 6;
  static constexpr int endpoint_count = 12;
  static constexpr int color_bits = 7;
  static constexpr int alpha_bits = 0;
  static constexpr int weight_bits = 2;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 2;
  static constexpr int p_bits = 1;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 3;
};
template <> struct Bc7Mode<4> {
  static constexpr int id = 4;
  static constexpr int pat_bits = 0;
  static constexpr int endpoint_count = 8;
  static constexpr int color_bits = 5;
  static constexpr int alpha_bits = 6;
  static constexpr int weight_bits = 2;
  static constexpr int plane_count = 2;
  static constexpr int subset_count = 1;
  static constexpr int p_bits = 0;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 4;
};
template <> struct Bc7Mode<5> {
  static constexpr int id = 5;
  static constexpr int pat_bits = 0;
  static constexpr int endpoint_count = 8;
  static constexpr int color_bits = 7;
  static constexpr int alpha_bits = 8;
  static constexpr int weight_bits = 2;
  static constexpr int plane_count = 2;
  static constexpr int subset_count = 1;
  static constexpr int p_bits = 0;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 4;
};
template <> struct Bc7Mode<6> {
  static constexpr int id = 6;
  static constexpr int pat_bits = 0;
  static constexpr int endpoint_count = 8;
  static constexpr int color_bits = 7;
  static constexpr int alpha_bits = 7;
  static constexpr int weight_bits = 4;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 1;
  static constexpr int p_bits = 1;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 4;
};
template <> struct Bc7Mode<7> {
  static constexpr int id = 7;
  static constexpr int pat_bits = 6;
  static constexpr int endpoint_count = 16;
  static constexpr int color_bits = 5;
  static constexpr int alpha_bits = 5;
  static constexpr int weight_bits = 2;
  static constexpr int plane_count = 1;
  static constexpr int subset_count = 2;
  static constexpr int p_bits = 1;
  static constexpr int sp_bits = 0;
  static constexpr int channels = 4;
};

// BISE ranges; unquant_base indexes UNQUANT_LUT (-1: pure bits).
template <int R> struct BiseRange;
template <> struct BiseRange<0> {
  static constexpr int bits = 1;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<1> {
  static constexpr int bits = 0;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 0;
};
template <> struct BiseRange<2> {
  static constexpr int bits = 2;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<3> {
  static constexpr int bits = 0;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 3;
};
template <> struct BiseRange<4> {
  static constexpr int bits = 1;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 8;
};
template <> struct BiseRange<5> {
  static constexpr int bits = 3;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<6> {
  static constexpr int bits = 1;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 14;
};
template <> struct BiseRange<7> {
  static constexpr int bits = 2;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 24;
};
template <> struct BiseRange<8> {
  static constexpr int bits = 4;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<9> {
  static constexpr int bits = 2;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 36;
};
template <> struct BiseRange<10> {
  static constexpr int bits = 3;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 56;
};
template <> struct BiseRange<11> {
  static constexpr int bits = 5;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<12> {
  static constexpr int bits = 3;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 80;
};
template <> struct BiseRange<13> {
  static constexpr int bits = 4;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 120;
};
template <> struct BiseRange<14> {
  static constexpr int bits = 6;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<15> {
  static constexpr int bits = 4;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 168;
};
template <> struct BiseRange<16> {
  static constexpr int bits = 5;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 248;
};
template <> struct BiseRange<17> {
  static constexpr int bits = 7;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};
template <> struct BiseRange<18> {
  static constexpr int bits = 5;
  static constexpr int trits = 0;
  static constexpr int quints = 1;
  static constexpr int unquant_base = 344;
};
template <> struct BiseRange<19> {
  static constexpr int bits = 6;
  static constexpr int trits = 1;
  static constexpr int quints = 0;
  static constexpr int unquant_base = 504;
};
template <> struct BiseRange<20> {
  static constexpr int bits = 8;
  static constexpr int trits = 0;
  static constexpr int quints = 0;
  static constexpr int unquant_base = -1;
};

// Pattern families; base indexes every FAM_* table.
template <int F> struct Family;
template <> struct Family<0> {
  static constexpr int count = 30;
  static constexpr int n_anchors = 2;
  static constexpr int base = 0;
  static constexpr uint32_t ab_min_packed = 0xa9555554u;
  static constexpr uint32_t ab_max_packed = 0xaaaaaaa4u;
  static constexpr uint32_t bc7_ab_min_packed = 0x55555554u;
  static constexpr uint32_t bc7_ab_max_packed = 0xaaaaaa94u;
};
template <> struct Family<1> {
  static constexpr int count = 11;
  static constexpr int n_anchors = 3;
  static constexpr int base = 30;
  static constexpr uint32_t ab_min_packed = 0xfea95554u;
  static constexpr uint32_t ab_max_packed = 0xffffffe4u;
  static constexpr uint32_t bc7_ab_min_packed = 0xaa955554u;
  static constexpr uint32_t bc7_ab_max_packed = 0xffeaaa54u;
};
template <> struct Family<2> {
  static constexpr int count = 19;
  static constexpr int n_anchors = 2;
  static constexpr int base = 41;
  static constexpr uint32_t ab_min_packed = 0xa9555554u;
  static constexpr uint32_t ab_max_packed = 0xaaaaaaa4u;
  static constexpr uint32_t bc7_ab_min_packed = 0xa5555554u;
  static constexpr uint32_t bc7_ab_max_packed = 0xfffeaa54u;
};
template <> struct Family<3> {
  static constexpr int count = 1;
  static constexpr int n_anchors = 1;
  static constexpr int base = 60;
  static constexpr uint32_t ab_min_packed = 0x55555554u;
  static constexpr uint32_t ab_max_packed = 0x55555554u;
  static constexpr uint32_t bc7_ab_min_packed = 0x55555554u;
  static constexpr uint32_t bc7_ab_max_packed = 0x55555554u;
};

UB_TABLE uint8_t MODE_LUT[128] = {
  11, 0, 10, 3, 11, 15, 12, 7, 11, 18, 10, 5, 11, 14, 12, 9,
  11, 0, 10, 4, 11, 16, 12, 8, 11, 18, 10, 6, 11, 2, 12, 13,
  11, 0, 10, 3, 11, 17, 12, 7, 11, 18, 10, 5, 11, 14, 12, 9,
  11, 0, 10, 4, 11, 1, 12, 8, 11, 18, 10, 6, 11, 2, 12, 13,
  11, 0, 10, 3, 11, 19, 12, 7, 11, 18, 10, 5, 11, 14, 12, 9,
  11, 0, 10, 4, 11, 16, 12, 8, 11, 18, 10, 6, 11, 2, 12, 13,
  11, 0, 10, 3, 11, 17, 12, 7, 11, 18, 10, 5, 11, 14, 12, 9,
  11, 0, 10, 4, 11, 1, 12, 8, 11, 18, 10, 6, 11, 2, 12, 13
};
UB_TABLE uint8_t ASTC_QUINT_ENCODE[125] = {
  0, 1, 2, 3, 4, 8, 9, 10, 11, 12, 16, 17, 18, 19, 20, 24,
  25, 26, 27, 28, 5, 13, 21, 29, 6, 32, 33, 34, 35, 36, 40, 41,
  42, 43, 44, 48, 49, 50, 51, 52, 56, 57, 58, 59, 60, 37, 45, 53,
  61, 14, 64, 65, 66, 67, 68, 72, 73, 74, 75, 76, 80, 81, 82, 83,
  84, 88, 89, 90, 91, 92, 69, 77, 85, 93, 22, 96, 97, 98, 99, 100,
  104, 105, 106, 107, 108, 112, 113, 114, 115, 116, 120, 121, 122, 123, 124, 101,
  109, 117, 125, 30, 102, 103, 70, 71, 38, 110, 111, 78, 79, 46, 118, 119,
  86, 87, 54, 126, 127, 94, 95, 62, 39, 47, 55, 63, 31
};
UB_TABLE uint8_t ASTC_TRIT_ENCODE[243] = {
  0, 1, 2, 4, 5, 6, 8, 9, 10, 16, 17, 18, 20, 21, 22, 24,
  25, 26, 3, 7, 11, 19, 23, 27, 12, 13, 14, 32, 33, 34, 36, 37,
  38, 40, 41, 42, 48, 49, 50, 52, 53, 54, 56, 57, 58, 35, 39, 43,
  51, 55, 59, 44, 45, 46, 64, 65, 66, 68, 69, 70, 72, 73, 74, 80,
  81, 82, 84, 85, 86, 88, 89, 90, 67, 71, 75, 83, 87, 91, 76, 77,
  78, 128, 129, 130, 132, 133, 134, 136, 137, 138, 144, 145, 146, 148, 149, 150,
  152, 153, 154, 131, 135, 139, 147, 151, 155, 140, 141, 142, 160, 161, 162, 164,
  165, 166, 168, 169, 170, 176, 177, 178, 180, 181, 182, 184, 185, 186, 163, 167,
  171, 179, 183, 187, 172, 173, 174, 192, 193, 194, 196, 197, 198, 200, 201, 202,
  208, 209, 210, 212, 213, 214, 216, 217, 218, 195, 199, 203, 211, 215, 219, 204,
  205, 206, 96, 97, 98, 100, 101, 102, 104, 105, 106, 112, 113, 114, 116, 117,
  118, 120, 121, 122, 99, 103, 107, 115, 119, 123, 108, 109, 110, 224, 225, 226,
  228, 229, 230, 232, 233, 234, 240, 241, 242, 244, 245, 246, 248, 249, 250, 227,
  231, 235, 243, 247, 251, 236, 237, 238, 28, 29, 30, 60, 61, 62, 92, 93,
  94, 156, 157, 158, 188, 189, 190, 220, 221, 222, 31, 63, 95, 159, 191, 223,
  124, 125, 126
};
UB_TABLE uint8_t UNQUANT_LUT[696] = {
  0, 0, 0, 0, 0, 0, 0, 0, 0, 255, 51, 204, 102, 153, 0, 255,
  28, 227, 56, 199, 84, 171, 113, 142, 0, 255, 69, 186, 23, 232, 92, 163,
  46, 209, 116, 139, 0, 255, 67, 188, 13, 242, 80, 175, 27, 228, 94, 161,
  40, 215, 107, 148, 54, 201, 121, 134, 0, 255, 33, 222, 66, 189, 99, 156,
  11, 244, 44, 211, 77, 178, 110, 145, 22, 233, 55, 200, 88, 167, 121, 134,
  0, 255, 32, 223, 65, 190, 97, 158, 6, 249, 39, 216, 71, 184, 104, 151,
  13, 242, 45, 210, 78, 177, 110, 145, 19, 236, 52, 203, 84, 171, 117, 138,
  26, 229, 58, 197, 91, 164, 123, 132, 0, 255, 16, 239, 32, 223, 48, 207,
  65, 190, 81, 174, 97, 158, 113, 142, 5, 250, 21, 234, 38, 217, 54, 201,
  70, 185, 86, 169, 103, 152, 119, 136, 11, 244, 27, 228, 43, 212, 59, 196,
  76, 179, 92, 163, 108, 147, 124, 131, 0, 255, 16, 239, 32, 223, 48, 207,
  64, 191, 80, 175, 96, 159, 112, 143, 3, 252, 19, 236, 35, 220, 51, 204,
  67, 188, 83, 172, 100, 155, 116, 139, 6, 249, 22, 233, 38, 217, 54, 201,
  71, 184, 87, 168, 103, 152, 119, 136, 9, 246, 25, 230, 42, 213, 58, 197,
  74, 181, 90, 165, 106, 149, 122, 133, 13, 242, 29, 226, 45, 210, 61, 194,
  77, 178, 93, 162, 109, 146, 125, 130, 0, 255, 8, 247, 16, 239, 24, 231,
  32, 223, 40, 215, 48, 207, 56, 199, 64, 191, 72, 183, 80, 175, 88, 167,
  96, 159, 104, 151, 112, 143, 120, 135, 2, 253, 10, 245, 18, 237, 26, 229,
  35, 220, 43, 212, 51, 204, 59, 196, 67, 188, 75, 180, 83, 172, 91, 164,
  99, 156, 107, 148, 115, 140, 123, 132, 5, 250, 13, 242, 21, 234, 29, 226,
  37, 218, 45, 210, 53, 202, 61, 194, 70, 185, 78, 177, 86, 169, 94, 161,
  102, 153, 110, 145, 118, 137, 126, 129, 0, 255, 8, 247, 16, 239, 24, 231,
  32, 223, 40, 215, 48, 207, 56, 199, 64, 191, 72, 183, 80, 175, 88, 167,
  96, 159, 104, 151, 112, 143, 120, 135, 1, 254, 9, 246, 17, 238, 25, 230,
  33, 222, 41, 214, 49, 206, 57, 198, 65, 190, 73, 182, 81, 174, 89, 166,
  97, 158, 105, 150, 113, 142, 121, 134, 3, 252, 11, 244, 19, 236, 27, 228,
  35, 220, 43, 212, 51, 204, 59, 196, 67, 188, 75, 180, 83, 172, 91, 164,
  99, 156, 107, 148, 115, 140, 123, 132, 4, 251, 12, 243, 20, 235, 28, 227,
  36, 219, 44, 211, 52, 203, 60, 195, 68, 187, 76, 179, 84, 171, 92, 163,
  100, 155, 108, 147, 116, 139, 124, 131, 6, 249, 14, 241, 22, 233, 30, 225,
  38, 217, 46, 209, 54, 201, 62, 193, 70, 185, 78, 177, 86, 169, 94, 161,
  102, 153, 110, 145, 118, 137, 126, 129, 0, 255, 4, 251, 8, 247, 12, 243,
  16, 239, 20, 235, 24, 231, 28, 227, 32, 223, 36, 219, 40, 215, 44, 211,
  48, 207, 52, 203, 56, 199, 60, 195, 64, 191, 68, 187, 72, 183, 76, 179,
  80, 175, 84, 171, 88, 167, 92, 163, 96, 159, 100, 155, 104, 151, 108, 147,
  112, 143, 116, 139, 120, 135, 124, 131, 1, 254, 5, 250, 9, 246, 13, 242,
  17, 238, 21, 234, 25, 230, 29, 226, 33, 222, 37, 218, 41, 214, 45, 210,
  49, 206, 53, 202, 57, 198, 61, 194, 65, 190, 69, 186, 73, 182, 77, 178,
  81, 174, 85, 170, 89, 166, 93, 162, 97, 158, 101, 154, 105, 150, 109, 146,
  113, 142, 117, 138, 121, 134, 125, 130, 2, 253, 6, 249, 10, 245, 14, 241,
  18, 237, 22, 233, 26, 229, 30, 225, 34, 221, 38, 217, 42, 213, 46, 209,
  50, 205, 54, 201, 58, 197, 62, 193, 66, 189, 70, 185, 74, 181, 78, 177,
  82, 173, 86, 169, 90, 165, 94, 161, 98, 157, 102, 153, 106, 149, 110, 145,
  114, 141, 118, 137, 122, 133, 126, 129
};
UB_TABLE uint32_t FAM_ANCHORS_PACKED[61] = {
  0x00000020, 0x00000030, 0x00000001, 0x00000030, 0x00000007, 0x00000020, 0x00000003, 0x00000007,
  0x000000b0, 0x00000002, 0x00000070, 0x0000000b, 0x00000003, 0x00000008, 0x00000040, 0x0000000c,
  0x00000001, 0x00000008, 0x00000010, 0x00000020, 0x00000040, 0x00000008, 0x00000001, 0x00000020,
  0x00000004, 0x00000010, 0x00000004, 0x00000001, 0x00000004, 0x00000001, 0x00000a80, 0x00000c08,
  0x00000c04, 0x00000408, 0x00000203, 0x00000310, 0x00000120, 0x00000091, 0x00000021, 0x00000804,
  0x00000260, 0x00000040, 0x00000020, 0x00000002, 0x00000070, 0x00000008, 0x00000010, 0x00000030,
  0x00000010, 0x00000002, 0x00000010, 0x00000080, 0x00000002, 0x00000010, 0x00000070, 0x0000000c,
  0x00000002, 0x00000009, 0x00000020, 0x00000004, 0x00000000
};
UB_TABLE uint32_t FAM_ANCHORS_BEFORE_PACKED[61] = {
  0xaaaaaa94, 0xaaaaaa54, 0xaaaaaaa4, 0xaaaaaa54, 0xaaaa5554, 0xaaaaaa94, 0xaaaaaa54, 0xaaaa5554,
  0xaa555554, 0xaaaaaa94, 0xaaaa5554, 0xaa555554, 0xaaaaaa54, 0xaaa95554, 0xaaaaa954, 0xa9555554,
  0xaaaaaaa4, 0xaaa95554, 0xaaaaaaa4, 0xaaaaaa94, 0xaaaaa954, 0xaaa95554, 0xaaaaaaa4, 0xaaaaaa94,
  0xaaaaa954, 0xaaaaaaa4, 0xaaaaa954, 0xaaaaaaa4, 0xaaaaa954, 0xaaaaaaa4, 0xffe95554, 0xfea95554,
  0xfeaaa954, 0xfffea954, 0xffffff94, 0xffffffa4, 0xffffffe4, 0xfffaaaa4, 0xffffffe4, 0xfffea954,
  0xffffea94, 0xaaaaa954, 0xaaaaaa94, 0xaaaaaa94, 0xaaaa5554, 0xaaa95554, 0xaaaaaaa4, 0xaaaaaa54,
  0xaaaaaaa4, 0xaaaaaa94, 0xaaaaaaa4, 0xaaa95554, 0xaaaaaa94, 0xaaaaaaa4, 0xaaaa5554, 0xa9555554,
  0xaaaaaa94, 0xaaa55554, 0xaaaaaa94, 0xaaaaa954, 0x55555554
};
UB_TABLE uint8_t FAM_BC7_INDEX[61] = {
  0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
  17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 29, 32, 33, 52, 4, 8,
  9, 10, 11, 12, 13, 20, 35, 36, 57, 10, 11, 0, 2, 8, 13, 1,
  33, 40, 20, 21, 58, 3, 32, 59, 34, 20, 14, 31, 0
};
UB_TABLE uint32_t FAM_BC7_PAT_PACKED[61] = {
  0x50505050, 0x40404040, 0x54545454, 0x54505040, 0x50404000, 0x55545450, 0x55545040, 0x54504000,
  0x50400000, 0x55555450, 0x55544000, 0x54400000, 0x55555440, 0x55550000, 0x55555500, 0x55000000,
  0x00004054, 0x15010000, 0x00405054, 0x00004050, 0x15050100, 0x05010000, 0x40505054, 0x00404050,
  0x05010100, 0x14141414, 0x00555500, 0x44444444, 0x55005500, 0x50410514, 0xa5a50000, 0xaa550000,
  0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa8a85454, 0x24242424, 0x00aa5500,
  0xa05050a0, 0xaaaa5500, 0x90909090, 0xaa685050, 0x5a5a4200, 0xaa550000, 0xa4a4a4a4, 0x6a5a5040,
  0x5090a0a8, 0x500aa550, 0xa8a85454, 0x6a6a4040, 0xa0a5a5a0, 0x5450a0a8, 0xa9a58000, 0x96000000,
  0xa8a09050, 0xa8a85454, 0xa9a59450, 0x6a5a0200, 0x50505050
};
UB_TABLE uint32_t FAM_BC7_ANCHORS_PACKED[61] = {
  0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0,
  0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0, 0x000000f0,
  0x00000020, 0x00000080, 0x00000020, 0x00000020, 0x00000080, 0x00000080, 0x000000f0, 0x00000020,
  0x00000080, 0x00000020, 0x00000080, 0x000000f0, 0x000000f0, 0x000000f0, 0x00000f80, 0x00000f80,
  0x00000f80, 0x00000f60, 0x00000f60, 0x00000f60, 0x00000f50, 0x00000f30, 0x00000a50, 0x00000a60,
  0x00000fa0, 0x00000f60, 0x00000f60, 0x00000f30, 0x000008f0, 0x00000f80, 0x00000f50, 0x00000830,
  0x000003f0, 0x000006f0, 0x00000f30, 0x00000830, 0x00000f80, 0x000003f0, 0x00000f80, 0x00000fd0,
  0x00000f30, 0x00000f30, 0x00000f30, 0x000008f0, 0x000000f0
};
UB_TABLE uint32_t FAM_PERM_PACKED[61] = {
  0x00000010, 0x00000010, 0x00000001, 0x00000010, 0x00000001, 0x00000010, 0x00000001, 0x00000001,
  0x00000010, 0x00000001, 0x00000010, 0x00000001, 0x00000001, 0x00000001, 0x00000010, 0x00000001,
  0x00000001, 0x00000001, 0x00000010, 0x00000010, 0x00000010, 0x00000001, 0x00000001, 0x00000010,
  0x00000001, 0x00000010, 0x00000001, 0x00000001, 0x00000001, 0x00000001, 0x00000210, 0x00000201,
  0x00000201, 0x00000021, 0x00000021, 0x00000210, 0x00000120, 0x00000102, 0x00000102, 0x00000201,
  0x00000210, 0x00000010, 0x00000010, 0x00000001, 0x00000010, 0x00000101, 0x00000010, 0x00000110,
  0x00000110, 0x00000001, 0x00000010, 0x00000100, 0x00000001, 0x00000100, 0x00000110, 0x00000011,
  0x00000001, 0x00000011, 0x00000010, 0x00000001, 0x00000000
};
UB_TABLE uint32_t FAM_BC7_WEIGHT_PRESHIFT_PACKED[61] = {
  0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540,
  0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540, 0x55555540,
  0x00000000, 0x00015540, 0x00000000, 0x00000000, 0x00015540, 0x00015540, 0x55555540, 0x00000000,
  0x00015540, 0x00000000, 0x00015540, 0x55555540, 0x55555540, 0x55555540, 0x55415500, 0x55415500,
  0x55415500, 0x55401500, 0x55401500, 0x55401500, 0x55400500, 0x55400000, 0x00000500, 0x00001500,
  0x55555500, 0x55541500, 0x55541500, 0x55540000, 0x55555500, 0x55555500, 0x55540500, 0x00000000,
  0x55540000, 0x55541500, 0x55540000, 0x00000000, 0x55555500, 0x55540000, 0x55555500, 0x5aa95500,
  0x55540000, 0x55540000, 0x55540000, 0x55555500, 0x00000000
};
UB_TABLE uint32_t FAM_PAT_PACKED[61] = {
  0x50505050, 0x40404040, 0x01010101, 0x54505040, 0x05151555, 0x55545450, 0x00010515, 0x01051555,
  0x50400000, 0x00000105, 0x55544000, 0x01155555, 0x00000115, 0x00005555, 0x55555500, 0x00555555,
  0x55551501, 0x40545555, 0x00405054, 0x00004050, 0x15050100, 0x50545555, 0x15050501, 0x00404050,
  0x50545455, 0x14141414, 0x55000055, 0x11111111, 0x00550055, 0x05145041, 0xa5a50000, 0xaa005555,
  0xaa000055, 0x0000aa55, 0x25252525, 0x94949494, 0x58585858, 0x56560202, 0x92929292, 0x55aa0055,
  0xa05050a0, 0x00005500, 0x10101010, 0x00010505, 0x50504000, 0x55005555, 0x04040404, 0x55555040,
  0x50505054, 0x05500005, 0x00005454, 0x15150000, 0x05000005, 0x00005054, 0x55554000, 0x14555555,
  0x01050505, 0x01015555, 0x01051450, 0x00005455, 0x50505050
};
UB_TABLE uint16_t FAM_ASTC_INDEX10[61] = {
  28, 20, 16, 29, 91, 9, 107, 72, 149, 204, 50, 114, 496, 17, 78, 39,
  252, 828, 43, 156, 116, 210, 476, 273, 684, 359, 246, 195, 694, 524, 260, 74,
  32, 156, 183, 15, 745, 0, 335, 902, 254, 36, 48, 61, 137, 161, 183, 226,
  281, 302, 307, 479, 495, 593, 594, 605, 799, 812, 988, 993, 0
};
UB_TABLE uint32_t FAM_BC7_INV_RELPOS_PACKED[91] = {
  0x0000009e, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad,
  0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad, 0x000000ad,
  0x000000ad, 0x00000086, 0x00000019, 0x00000086, 0x00000007, 0x00000098, 0x00000019, 0x000000ad,
  0x00000007, 0x00000098, 0x00000086, 0x00000098, 0x000000ad, 0x000000ad, 0x000000ad, 0x00009c10,
  0x00009c10, 0x00009c8f, 0x00009c8b, 0x00009c8a, 0x00009c8a, 0x00009c88, 0x00009c85, 0x00009288,
  0x0000928b, 0x00009c92, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d,
  0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d, 0x0000009d,
  0x0000009d, 0x0000009d, 0x00000083, 0x00000010, 0x00000083, 0x00000004, 0x0000008f, 0x00000010,
  0x0000009d, 0x00000004, 0x0000008f, 0x00000083, 0x0000008f, 0x0000009d, 0x0000009d, 0x0000009d,
  0x00009d8b, 0x00009d8b, 0x00009d85, 0x00008f9d, 0x00009d10, 0x00009d89, 0x00008f06, 0x0000859d,
  0x00008b9d, 0x00009d85, 0x00001086, 0x00009d8f, 0x0000859d, 0x00009d8f, 0x00009d99, 0x00009d85,
  0x00009d86, 0x00009d85, 0x00008f9d
};
UB_TABLE uint16_t BC7_MODE_5_OPTIMAL_PACKED[256] = {
  0, 128, 384, 512, 768, 896, 1152, 1280, 1536, 1664, 1920, 2048, 2304, 2560, 2688, 2944,
  3072, 3328, 3456, 3712, 3840, 4096, 4224, 4480, 4608, 4864, 4992, 5248, 5376, 5632, 5760, 6016,
  6144, 6400, 6656, 6784, 7040, 7168, 7424, 7552, 7808, 7936, 8192, 8320, 8448, 8704, 8832, 9088,
  9216, 9472, 9600, 9856, 9984, 10240, 10496, 10624, 10880, 11008, 11264, 11392, 11648, 11776, 12032, 12160,
  12416, 12544, 12800, 12928, 13184, 13312, 13568, 13696, 13952, 14080, 14336, 14592, 14720, 14976, 15104, 15360,
  15488, 15744, 15872, 16128, 16256, 16257, 16130, 16131, 16259, 16260, 16133, 16134, 16262, 16263, 16136, 16137,
  16265, 16266, 16139, 16140, 16268, 16269, 16142, 16015, 16271, 16144, 16145, 16273, 16274, 16147, 16148, 16276,
  16277, 16150, 16151, 16279, 16280, 16153, 16154, 16282, 16283, 16156, 16157, 16285, 16286, 16159, 16160, 16288,
  16289, 16162, 16163, 16291, 16292, 16165, 16166, 16294, 16295, 16168, 16169, 16297, 16298, 16171, 16172, 16300,
  16301, 16174, 16047, 16303, 16176, 16177, 16305, 16306, 16179, 16180, 16308, 16309, 16182, 16183, 16311, 16312,
  16185, 16186, 16314, 16315, 16188, 16189, 16317, 16318, 16191, 16064, 16192, 16193, 16321, 16322, 16195, 16196,
  16324, 16325, 16198, 16199, 16327, 16328, 16201, 16202, 16330, 16331, 16204, 16077, 16333, 16206, 16207, 16335,
  16336, 16209, 16210, 16338, 16339, 16212, 16213, 16341, 16342, 16215, 16216, 16344, 16345, 16218, 16219, 16347,
  16348, 16221, 16222, 16350, 16351, 16224, 16225, 16353, 16354, 16227, 16228, 16356, 16357, 16230, 16231, 16359,
  16360, 16233, 16234, 16362, 16363, 16236, 16109, 16365, 16238, 16239, 16367, 16368, 16241, 16242, 16370, 16371,
  16244, 16245, 16373, 16374, 16247, 16248, 16376, 16377, 16250, 16251, 16379, 16380, 16253, 16254, 16382, 16383
};
UB_TABLE uint16_t BC7_MODE_6_OPTIMAL_PACKED[257] = {
  0, 0, 128, 384, 512, 768, 896, 1152, 1280, 1536, 1664, 1920, 2048, 2304, 2560, 2688,
  2944, 3072, 3328, 3456, 3712, 3840, 4096, 4224, 4480, 4608, 4864, 4992, 5248, 5376, 5632, 5760,
  6016, 6144, 6400, 6656, 6784, 7040, 7168, 7424, 7552, 7808, 7936, 8192, 8320, 8576, 8704, 8960,
  9088, 9344, 9472, 9728, 9856, 10112, 10240, 10496, 10752, 10880, 11136, 11264, 11520, 11648, 11904, 12032,
  12288, 12416, 12672, 12800, 13056, 13184, 13440, 13568, 13824, 13952, 14208, 14336, 14592, 14848, 14976, 15232,
  15360, 15616, 15744, 16000, 16128, 16129, 16257, 16258, 16131, 16132, 16260, 16261, 16134, 16135, 16263, 16264,
  16137, 16138, 16266, 16267, 16140, 16013, 16269, 16142, 16143, 16271, 16272, 16145, 16146, 16274, 16275, 16148,
  16149, 16277, 16278, 16151, 16152, 16280, 16281, 16154, 16155, 16283, 16284, 16157, 16158, 16286, 16287, 16160,
  16161, 16289, 16290, 16163, 16164, 16292, 16293, 16166, 16167, 16295, 16296, 16169, 16170, 16298, 16299, 16172,
  16045, 16301, 16174, 16175, 16303, 16304, 16177, 16178, 16306, 16307, 16180, 16181, 16309, 16310, 16183, 16184,
  16312, 16313, 16186, 16187, 16315, 16316, 16189, 16190, 16318, 16319, 16192, 16193, 16321, 16322, 16195, 16196,
  16324, 16325, 16198, 16199, 16327, 16328, 16201, 16202, 16330, 16331, 16204, 16077, 16333, 16206, 16207, 16335,
  16336, 16209, 16210, 16338, 16339, 16212, 16213, 16341, 16342, 16215, 16216, 16344, 16345, 16218, 16219, 16347,
  16348, 16221, 16222, 16350, 16351, 16224, 16225, 16353, 16354, 16227, 16228, 16356, 16357, 16230, 16231, 16359,
  16360, 16233, 16234, 16362, 16363, 16236, 16109, 16365, 16238, 16239, 16367, 16368, 16241, 16242, 16370, 16371,
  16244, 16245, 16373, 16374, 16247, 16248, 16376, 16377, 16250, 16251, 16379, 16380, 16253, 16254, 16382, 16383,
  16383
};
UB_TABLE uint32_t ETC1_MOD_PACKED[8] = {
  0x00000802, 0x00001105, 0x00001d09, 0x00002a0d, 0x00003c12, 0x00005018, 0x00006a21, 0x0000b72f
};
UB_TABLE uint32_t ETC_BIAS_PACKED[32] = {
  0x00000555, 0x00000596, 0x00000aa9, 0x00000659, 0x0000069a, 0x00000aa6, 0x00000a9a, 0x00000aab,
  0x00000eaa, 0x00000965, 0x00000000, 0x00000aae, 0x00000a69, 0x00000aaa, 0x00000aeb, 0x00000aba,
  0x00000bae, 0x00000bef, 0x00000a6a, 0x000009aa, 0x000006aa, 0x00000aea, 0x00000eba, 0x00000efb,
  0x00000baa, 0x00000fbe, 0x00000fff, 0x00000a95, 0x0000057f, 0x00000fea, 0x0000056a, 0x00000abf
};
UB_TABLE uint32_t EAC_MOD_PACKED[32] = {
  0x0006090c, 0x1d171411, 0x0205080c, 0x1b181511, 0x02070a0d, 0x1b161310, 0x02090b0d, 0x1b141210,
  0x0307090c, 0x1a161411, 0x0406080c, 0x19171511, 0x0407080b, 0x19161512, 0x04070a0c, 0x19161311,
  0x0507090d, 0x18161410, 0x05070a0d, 0x18161310, 0x05070b0d, 0x18161210, 0x05080a0d, 0x18151310,
  0x05080b0c, 0x18151211, 0x050c0d0e, 0x1811100f, 0x0607090b, 0x17161412, 0x06080a0c, 0x17151311
};
UB_TABLE uint32_t EAC_FRACTION_BITS[16] = {
  0x3f0469ee, 0x3f051eb8, 0x3f051eb8, 0x3f051eb8, 0x3f0590b2, 0x3f061862, 0x3f061862, 0x3f061862,
  0x3f06bca2, 0x3f06bca2, 0x3f06bca2, 0x3f06bca2, 0x3f06bca2, 0x3f06bca2, 0x3f078788, 0x3f078788
};

}  // namespace ub
