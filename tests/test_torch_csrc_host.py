"""PyTorch port: the K1 kernel's own per-block source, compiled for the host.

`basisu_rs_tpu_torch/csrc/uastc_bc7.cuh` holds the kernel's per-block logic
behind a macro shim, so g++ builds the exact code the CUDA kernel runs.  This
test builds it into a temporary directory, calls it over ctypes and holds
it against the plain PyTorch version (tolerance 0): shift, signedness and
table-index faults show here without a card.  The package never loads this
build; it skips only when g++ is absent."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.ops import bc7, build

HOST_ENTRY = r"""
#include <string.h>
#include "uastc_bc7.cuh"

template <int M>
static void run(const uint8_t* in, long long n, uint8_t* out, uint8_t* err) {
  for (long long t = 0; t < n; ++t) {
    uint32_t l[4], o[4];
    memcpy(l, in + 16 * t, 16);
    err[t] = ub::uastc_to_bc7<M>(l, o) ? 1 : 0;
    memcpy(out + 16 * t, o, 16);
  }
}

typedef void (*RunFn)(const uint8_t*, long long, uint8_t*, uint8_t*);
static const RunFn kRun[19] = {run<0>,  run<1>,  run<2>,  run<3>,  run<4>,  run<5>,  run<6>,
                               run<7>,  run<8>,  run<9>,  run<10>, run<11>, run<12>, run<13>,
                               run<14>, run<15>, run<16>, run<17>, run<18>};

extern "C" void uastc_bc7_host(int mode, const uint8_t* in, long long n, uint8_t* out,
                               uint8_t* err) {
  kRun[mode](in, n, out, err);
}

extern "C" float fl_div255_host(int x) { return ub::fl_div255(x); }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed; the host build of the kernel source needs it")
    d = tmp_path_factory.mktemp("uastc_bc7_host")
    (d / "host_entry.cpp").write_text(HOST_ENTRY)
    so = d / "libuastc_bc7_host.so"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-Wall", "-Wno-unknown-pragmas",
           "-Werror", "-shared", "-fPIC", "-I", str(build.CSRC), "-o", str(so), str(d / "host_entry.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.uastc_bc7_host.restype = None
    lib.uastc_bc7_host.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.fl_div255_host.restype = ctypes.c_float
    lib.fl_div255_host.argtypes = [ctypes.c_int]
    return lib


def _mode_blocks(golden, mode):
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(1000 + mode)
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (4096, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, len(r))
    gold = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


@pytest.mark.parametrize("mode", range(19))
def test_host_build_matches_plain(host_lib, golden, mode):
    blocks = _mode_blocks(golden, mode)
    out = np.zeros_like(blocks)
    err = np.zeros(len(blocks), np.uint8)
    host_lib.uastc_bc7_host(mode, blocks.ctypes.data, len(blocks), out.ctypes.data, err.ctypes.data)

    t = torch.from_numpy(blocks)
    p_out = torch.zeros_like(t)
    p_err = torch.zeros(len(blocks), dtype=torch.bool)
    bc7.transcode_rows(mode, t, None, p_out, p_err)
    bad = np.nonzero(np.any(out != p_out.numpy(), axis=1) | (err.astype(bool) != p_err.numpy()))[0]
    assert bad.size == 0, (
        f"mode {mode}: {bad.size} blocks differ; first {blocks[bad[0]].tolist()}\n"
        f"host {out[bad[0]].tolist()} err {err[bad[0]]}\n"
        f"plain {p_out.numpy()[bad[0]].tolist()} err {bool(p_err[bad[0]])}"
    )


def test_host_fl_div255_exhaustive(host_lib):
    got = np.array([host_lib.fl_div255_host(x) for x in range(256)], np.float32)
    expect = (np.arange(256, dtype=np.float32) / np.float32(255.0)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
