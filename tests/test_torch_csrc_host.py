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
plane), the EAC selector search, K5's alpha-key lookup and bit scans, the
ETC1 selector forms, the subblock average and the bias rule; K5's alpha
range is held at its edges (one key, the extreme keys).  The package never
loads this build; it skips only when g++ is absent.  The last tests check
the ptxas report and SASS count parsers of `ops/build.py` on canned
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
from basisu_rs_tpu_torch.ops.uastc_decode import decode_weights
from basisu_rs_tpu_torch.tables import MODES, device_tables
from torch_cases import bias_reference, eac_reference_selectors, etc1_selector_cases, etc1s_inputs

HOST_ENTRY = r"""
#include <string.h>
#include "etc1s.cuh"
#include "uastc_astc.cuh"
#include "uastc_bc7.cuh"
#include "uastc_bc7_stages.cuh"
#include "uastc_etc.cuh"
#include "uastc_rgba.cuh"

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
#define STAGE_ROW(M) {stage_fn<M, 0>(), stage_fn<M, 1>(), stage_fn<M, 2>(), stage_fn<M, 3>(), stage_fn<M, 4>()}
static const StageFn kStage[19][5] = {STAGE_ROW(0),  STAGE_ROW(1),  STAGE_ROW(2),  STAGE_ROW(3),  STAGE_ROW(4),
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
// ETC1 wire bits ms | ls << 1 of n (luminance, 3 thresholds) cases.
extern "C" void etc1_selectors_host(const int* lum, const int* th, int n, uint8_t* out) {
  for (int k = 0; k < n; ++k) {
    const int32_t t[3] = {th[3 * k], th[3 * k + 1], th[3 * k + 2]};
    uint32_t ms, ls;
    ub::etc1_selector(lum[k], t, ms, ls);
    out[k] = static_cast<uint8_t>(ms | (ls << 1));
  }
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
                       ("etc1s_host", [i, p, i, p, i, p, p, p, p, ctypes.c_longlong, p])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    lib.texel_weights_host.restype = ctypes.c_int
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
