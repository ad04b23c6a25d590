"""Build the package's native sources at first use and bind them with ctypes.

Every library lands under `basisu_rs_tpu_torch/build/` (listed in
.gitignore), named by a hash of its sources and flags, so a changed source
rebuilds and an unchanged one loads the library already built; a build
writes a temporary file and renames it into place, so a failed or
concurrent build never leaves a partial library behind.

`csrc/*.cu` compiles with nvcc into one library with a plain C interface:
each `.cu` to an object in its own nvcc process, all started together, and
one nvcc then links them.  The build writes nvcc's output, including the
`-Xptxas -v` register and spill report of every kernel, beside the library
(`build_log()`, `ptxas_report()`); `sass_counts()` counts each kernel's
SASS instructions in the built library with the toolkit's cuobjdump.
`host_library()` builds one host C++ source with g++ (the container's
CRC-16, the ETC1S front-end).

Nothing here runs at import time: `load()` is called by the kernel wrapper
on the first CUDA launch.  There is no fallback: a missing compiler or a
failed build raises.
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

# target -> C launch entry point of its per-mode kernels (csrc/uastc_<target>.cu)
LAUNCH = {
    "bc7": "uastc_bc7_launch",
    "astc": "uastc_astc_launch",
    "rgba": "uastc_rgba_launch",
    "etc1": "uastc_etc1_launch",
    "etc2": "uastc_etc2_launch",
}
# target -> C entry point that launches its kernel over blocks of every mode
# at once (uastc_kernel_tiles<Op>, csrc/uastc_launch.cuh), and the one that
# reports that kernel's resident warps per SM
LAUNCH_TILES = {"bc7": "uastc_bc7_launch_tiles"}
TILES_WARPS = {"bc7": "uastc_bc7_tiles_warps"}
# target -> C entry point that reports its kernels' resident warps per SM
WARPS = {t: f"uastc_{t}_warps" for t in LAUNCH}
# C launch entry point of the ETC1S kernels K6-K9 (csrc/etc1s.cu)
ETC1S_LAUNCH = "etc1s_launch"
ETC1S_KINDS = ("rgba", "alpha", "rgba_alpha", "etc1")  # the kernels' KIND 0..3
# C launch entry point of the K1 stage kernels T1 (csrc/uastc_bc7_stages.cu)
# and their stages, index = the kernels' S
BC7_STAGE_LAUNCH = "bc7_stage_launch"
BC7_STAGES = ("full", "decode_endpoints", "decode_weights", "decode_fields", "pbit", "permute_invert")
# C launch entry point of the fl_div255 probe P (csrc/fl_div255_probe.cu)
PROBE_LAUNCH = "fl_div255_launch"


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


def _library_path(prefix: str, flags, sources) -> Path:
    """BUILD/<prefix>_<hash>.so, the hash over the flags and every source's
    name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"{prefix}_{h.hexdigest()[:16]}.so"


def _make_library(so: Path, make) -> None:
    """make(tmp) writes the library to tmp and returns (log text, ok); on
    success tmp is renamed to `so`, on failure removed and the log raised."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    text, ok = make(tmp)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {so.name} failed:\n{text}")
    os.replace(tmp, so)


def _run(cmd) -> tuple[str, int]:
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return " ".join(cmd) + "\n" + res.stdout, res.returncode


def _paths():
    cus, cuhs = _sources()
    so = _library_path("libbasisu_cuda", NVCC_FLAGS, cus + cuhs)
    return so, so.with_suffix(".log")


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu; returns (library path, seconds).  Raises on failure."""
    so, log = _paths()
    cus, _ = _sources()
    nvcc = nvcc_path()
    objs = [so.with_name(f"{so.stem}.{cu.stem}.{os.getpid()}.o") for cu in cus]

    def make(tmp):
        compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(cu)] for cu, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in compiles]
        steps = [(" ".join(c) + "\n" + p.communicate()[0], p.returncode) for c, p in zip(compiles, procs)]
        if all(rc == 0 for _, rc in steps):
            steps.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                               *map(str, objs)]))
        for o in objs:
            o.unlink(missing_ok=True)
        text = "".join(t for t, _ in steps)
        log.write_text(text)
        return text, all(rc == 0 for _, rc in steps)

    t0 = time.perf_counter()
    _make_library(so, make)
    return so, time.perf_counter() - t0


@lru_cache(maxsize=None)
def host_library(source: Path) -> ctypes.CDLL:
    """One host C++ source built with g++ (GXX_FLAGS) at first use and
    loaded; raises when g++ is missing or fails.  The caller binds the
    argument types."""
    so = _library_path(f"lib{source.stem}", GXX_FLAGS, [source])
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: {source.name} is built with g++")

        def make(tmp):
            text, rc = _run([gxx, *GXX_FLAGS, "-o", str(tmp), str(source)])
            return text, rc == 0

        _make_library(so, make)
    return ctypes.CDLL(str(so))


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, building it first if its sources changed."""
    so, _ = _paths()
    if not so.exists():
        build()
    lib = ctypes.CDLL(str(so))
    for name in LAUNCH.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,  # mode
            ctypes.c_void_p,  # in
            ctypes.c_void_p,  # index (or None)
            ctypes.c_int,  # n
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # err
            ctypes.c_void_p,  # stream
        ]
    for name in WARPS.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]  # mode, int* warps
    for name in LAUNCH_TILES.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # in
            ctypes.c_int,  # n
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # err
            ctypes.c_void_p,  # int64 warp-round counter on the card (or None)
            ctypes.c_void_p,  # stream
        ]
    for name in TILES_WARPS.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]  # int* warps
    fn = getattr(lib, ETC1S_LAUNCH)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # kind
        ctypes.c_void_p,  # endpoint codebook words
        ctypes.c_int,  # its length
        ctypes.c_void_p,  # selector (or wire) codebook words
        ctypes.c_int,  # its length
        ctypes.c_void_p,  # endpoint index stream
        ctypes.c_void_p,  # selector index stream
        ctypes.c_void_p,  # alpha slice's endpoint index stream (or None)
        ctypes.c_void_p,  # alpha slice's selector index stream (or None)
        ctypes.c_int,  # n
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    fn = getattr(lib, BC7_STAGE_LAUNCH)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_int,  # stage
        ctypes.c_void_p,  # in
        ctypes.c_int,  # n
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    fn = getattr(lib, PROBE_LAUNCH)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]  # x, n, out, stream
    return lib


def build_log() -> str:
    _, log = _paths()
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_KERNEL = re.compile(r"uastc_kernel.*\d(Bc7|Astc|Rgba|Etc1|Etc2)ILi(\d+)E")
_TILE_KERNEL = re.compile(r"uastc_kernel_tilesI.*\d(Bc7|Astc|Rgba|Etc1|Etc2)EE")
_ETC1S_KERNEL = re.compile(r"etc1s_kernelILi(\d)E")
_STAGE_KERNEL = re.compile(r"bc7_stage_kernelILi(\d+)ELi(\d)E")
_PROBE_KERNEL = re.compile(r"fl_div255_probe_kernel")


def _kernel_key(name: str):
    """(target, mode) of a uastc_kernel<Op<M>>, (target, "tiles") of a
    uastc_kernel_tiles<Op>, ("etc1s", kind) of an
    etc1s_kernel<KIND>, ("bc7_stage/<stage>", mode) of a
    bc7_stage_kernel<M, S>, ("probe", "fl_div255") of the probe, None for
    any other mangled name."""
    k = _KERNEL.search(name)
    if k:
        return k.group(1).lower(), int(k.group(2))
    k = _TILE_KERNEL.search(name)
    if k:
        return k.group(1).lower(), "tiles"
    k = _ETC1S_KERNEL.search(name)
    if k:
        return "etc1s", ETC1S_KINDS[int(k.group(1))]
    k = _STAGE_KERNEL.search(name)
    if k:
        return f"bc7_stage/{BC7_STAGES[int(k.group(2))]}", int(k.group(1))
    return ("probe", "fl_div255") if _PROBE_KERNEL.search(name) else None


def parse_ptxas(text: str) -> dict:
    """{key: {"registers", "stack", "spill_stores", "spill_loads"}} from the
    `-Xptxas -v` lines of an nvcc log, keyed as `_kernel_key` says
    (uastc_kernel<Op<M>>, etc1s_kernel<KIND>, bc7_stage_kernel<M, S> and
    the fl_div255 probe)."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = _kernel_key(m.group(1))
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


def ptxas_report() -> dict:
    """parse_ptxas() of the current build's log."""
    return parse_ptxas(build_log())


_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);")


def parse_sass(lines) -> dict:
    """{key: instructions} from `cuobjdump -sass` output, keyed as
    `_kernel_key` says: the static count of each kernel's SASS instructions,
    NOP padding left out."""
    out: dict = {}
    cur = None
    for line in lines:
        m = _SASS_FUNCTION.match(line)
        if m:
            cur = _kernel_key(m.group(1))
            if cur is not None:
                out[cur] = 0
            continue
        if cur is None:
            continue
        m = _SASS_INSTRUCTION.match(line)
        if m and m.group(1).split()[0] != "NOP":
            out[cur] += 1
    return out


def sass_counts() -> dict:
    """parse_sass() of the built library, through the toolkit's cuobjdump
    (beside nvcc); builds the library first if needed."""
    so, _ = _paths()
    if not so.exists():
        build()
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    with subprocess.Popen([str(cuobjdump), "-sass", str(so)], stdout=subprocess.PIPE, text=True) as proc:
        counts = parse_sass(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {so.name} failed with exit code {proc.returncode}")
    return counts
