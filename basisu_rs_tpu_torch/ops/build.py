"""Build the CUDA sources with nvcc at first use and bind them with ctypes.

`csrc/*.cu` compiles into one shared library with a plain C interface
under `basisu_rs_tpu_torch/build/` (listed in .gitignore), named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads the library already built.  The build writes nvcc's output, including
the `-Xptxas -v` register and spill report of every kernel, beside the
library (`build_log()`, `ptxas_report()`).

Nothing here runs at import time: `load()` is called by the kernel wrapper
on the first CUDA launch.  There is no fallback: a missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths():
    tag = source_hash()
    return BUILD / f"libbasisu_cuda_{tag}.so", BUILD / f"libbasisu_cuda_{tag}.log"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu; returns (library path, seconds).  Raises on failure."""
    so, log = _paths()
    BUILD.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, cus)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, seconds


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, building it first if its sources changed."""
    so, _ = _paths()
    if not so.exists():
        build()
    lib = ctypes.CDLL(str(so))
    lib.uastc_bc7_launch.restype = ctypes.c_int
    lib.uastc_bc7_launch.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_void_p,  # in
        ctypes.c_void_p,  # index (or None)
        ctypes.c_int,  # n
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # err
        ctypes.c_void_p,  # stream
    ]
    return lib


def build_log() -> str:
    _, log = _paths()
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_MODE = re.compile(r"uastc_bc7_kernelILi(\d+)EE")


def ptxas_report() -> dict:
    """{mode: {"registers", "stack", "spill_stores", "spill_loads"}} parsed
    from the `-Xptxas -v` lines of the build log."""
    out: dict = {}
    cur = None
    for line in build_log().splitlines():
        m = _ENTRY.search(line)
        if m:
            mm = _MODE.search(m.group(1))
            cur = int(mm.group(1)) if mm else None
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out
