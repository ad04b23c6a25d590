"""A/B timing of kernel-source variants on the card.

    python -m basisu_rs_tpu_torch.tools.csrc_ab TARGETS DIR [DIR ...] [--dump MODES --out OUT]

Each DIR holds a copy of `csrc/` (`*.cu`, `*.cuh`), edited or not.  For
every DIR the tool builds `uastc_<target>.cu` of each target in TARGETS (a
comma list of bc7, astc, rgba, etc1, etc2) with the package's nvcc flags
into its own library, then on the main path's cell (the golden blocks tiled
to 2^23, partitioned by mode) runs each variant's 19 launches, checks the
output against the tiled golden outputs, bit-exact, and times each mode's
launch and the 19 together (device time, median of 10, twice: the
variants in order, then in reverse).  Each line gives a variant's sums and, per mode, its time, registers, spill-store bytes and
SASS instructions.  Where a variant's library exports
`uastc_<target>_launch_tiles` (every mode in one launch), its one launch is
checked and timed too, on the tiled cell and on the same blocks drawn in a
seeded random order (the resident benchmark cell's mix), with its
registers, resident warps per SM and SASS count.
`--dump 9,13` writes the SASS of those modes' kernels to OUT (default
`basisu_rs_tpu_torch/build/csrc_ab/`) for reading, and the same SASS
annotated with the inlined source lines (a second build with -lineinfo,
`nvdisasm --print-line-info-inline`), which `tools/sass_split.py` reads.
Every variant runs in the same call, on the same card, so their times
compare; a time from another call does not.  Importing this module runs
nothing; the timing needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import build, kernels
from ..ops.dispatch import partition
from ..utils.profiling import event_times_ms

FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "golden_blocks.npz"
N_BLOCKS = 1 << 23
REPS = 10


def dump_lines(src: Path, targets, out: Path, dump_modes) -> None:
    """Write the line-annotated SASS of src's dump_modes kernels of each
    target to out/lines_<src>_<target>_<mode>.txt: a -lineinfo cubin (the
    package's nvcc flags otherwise) through nvdisasm."""
    nvcc = build.nvcc_path()
    cubins = [out / f"{src.name}_{t}.cubin" for t in targets]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-lineinfo", "-cubin", "-I", str(src), "-o", str(c),
                               str(src / f"uastc_{t}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for t, c in zip(targets, cubins)]
    logs = [p.communicate()[0] for p in procs]
    for t, c, p, log in zip(targets, cubins, procs, logs):
        if p.returncode:
            raise RuntimeError(f"-lineinfo build of {src} {t} failed:\n{log}")
        text = subprocess.run([str(Path(nvcc).with_name("nvdisasm")), "--print-line-info-inline", "-c", str(c)],
                              check=True, capture_output=True, text=True).stdout
        for (target, mode), lines in split_functions(text.splitlines(keepends=True)).items():
            if target == t and mode in dump_modes:
                (out / f"lines_{src.name}_{t}_{mode}.txt").write_text("".join(lines))


_SECTION = re.compile(r"^\s*\.section\s+\.text\.([^,\s]+)")


def split_functions(lines) -> dict:
    """{(target, mode): lines} of nvdisasm output, one entry a kernel."""
    out: dict = {}
    cur = None
    for line in lines:
        m = _SECTION.match(line)
        if m:
            cur = build._kernel_key(m.group(1))
        if cur is not None:
            out.setdefault(cur, []).append(line)
    return out


def tiles_launch(lib, target: str):
    """The library's one-launch entry of `target` (bound), or None."""
    name = build.LAUNCH_TILES.get(target)
    if name is None or not hasattr(lib, name):
        return None
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def tiles_warps(lib, target: str) -> int | None:
    """Resident warps per SM of the library's tile kernel of `target`."""
    name = build.TILES_WARPS.get(target)
    if name is None or not hasattr(lib, name):
        return None
    warps = ctypes.c_int(0)
    return warps.value if getattr(lib, name)(ctypes.byref(warps)) == 0 else None


def build_variant(src: Path, targets, out: Path, dump_modes):
    """(library, ptxas report, SASS counts) of src's targets, built into out."""
    nvcc = build.nvcc_path()
    so = out / f"lib_{src.name}.so"
    objs = [out / f"{src.name}_{t}.o" for t in targets]
    compiles = [[nvcc, *build.NVCC_FLAGS, "-I", str(src), "-c", "-o", str(o), str(src / f"uastc_{t}.cu")]
                for t, o in zip(targets, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in compiles]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"build of {src} failed:\n{log}")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(so), *map(str, objs)],
                   check=True, capture_output=True)
    dump = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout.splitlines(keepends=True)
    counts = build.parse_sass(dump)
    if dump_modes:
        cur = None
        texts: dict = {}
        for line in dump:
            m = build._SASS_FUNCTION.match(line)
            if m:
                cur = build._kernel_key(m.group(1))
            if cur is not None and cur[1] in dump_modes:
                texts.setdefault(cur, []).append(line)
        for (t, m), lines in texts.items():
            (out / f"sass_{src.name}_{t}_{m}.txt").write_text("".join(lines))
    lib = ctypes.CDLL(str(so))
    for t in targets:
        fn = getattr(lib, build.LAUNCH[t])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
    return lib, build.parse_ptxas(log), counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets")
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--dump", default="", help="comma list of modes whose SASS (plain and line-annotated) to write")
    ap.add_argument("--out", type=Path, default=build.BUILD / "csrc_ab")
    args = ap.parse_args(argv)
    targets = args.targets.split(",")
    args.out.mkdir(parents=True, exist_ok=True)
    dump_modes = {int(m) for m in args.dump.split(",") if m}
    if dump_modes:
        for d in args.dirs:
            dump_lines(d, targets, args.out, dump_modes)

    dev = torch.device("cuda")
    golden = np.load(FIXTURE)
    gin = golden["bc7_in"]
    reps = -(-N_BLOCKS // len(gin))
    full = torch.from_numpy(np.tile(gin, (reps, 1))[:N_BLOCKS]).to(dev)
    ((order, counts),) = partition([full])
    draw = torch.from_numpy(np.random.default_rng(0).integers(0, N_BLOCKS, N_BLOCKS)).to(dev)
    shuffled = full[draw].contiguous()
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    groups = [order[starts[m]:starts[m + 1]] for m in range(19)]
    variants = {d.name: build_variant(d, targets, args.out, dump_modes) for d in args.dirs}
    stream = torch.cuda.current_stream().cuda_stream

    def med(fn):
        return statistics.median(event_times_ms(fn, REPS, preload=True))

    for t in targets:
        ob = kernels.OUT_BYTES[t]
        expected = torch.from_numpy(np.tile(golden[f"{t}_out"].view(np.uint8).reshape(len(gin), ob),
                                            (reps, 1))[:N_BLOCKS]).to(dev)
        out = torch.zeros(N_BLOCKS, ob, dtype=torch.uint8, device=dev)
        err = torch.zeros(N_BLOCKS, dtype=torch.bool, device=dev)
        runs: dict = {}
        tile_runs: dict = {}
        for names in (list(variants), list(reversed(variants))):
            for name in names:
                lib = variants[name][0]
                launch = getattr(lib, build.LAUNCH[t])

                def go(m, name=name, launch=launch):
                    rc = launch(m, full.data_ptr(), groups[m].data_ptr(), groups[m].shape[0], out.data_ptr(),
                                err.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"{name} {t} mode {m}: launch failed, cudaError_t {rc}")

                def all19():
                    for m in range(19):
                        go(m)

                out.zero_()
                all19()
                if not torch.equal(out, expected) or bool(err.any()):
                    raise RuntimeError(f"{name} {t}: output differs from the tiled golden outputs")
                runs.setdefault(name, []).append((med(all19), [med(lambda m=m: go(m)) for m in range(19)]))
                tiles = tiles_launch(lib, t)
                if tiles is not None:
                    times = []
                    for x, want in ((full, expected), (shuffled, expected[draw])):
                        def one(x=x, tiles=tiles, name=name):
                            rc = tiles(x.data_ptr(), x.shape[0], out.data_ptr(), err.data_ptr(), None, stream)
                            if rc:
                                raise RuntimeError(f"{name} {t} tiles: launch failed, cudaError_t {rc}")

                        out.zero_()
                        one()
                        if not torch.equal(out, want) or bool(err.any()):
                            raise RuntimeError(f"{name} {t} tiles: output differs from the golden outputs")
                        times.append(med(one))
                    tile_runs.setdefault(name, []).append(times)
        for name, r in runs.items():
            _, ptxas, sass = variants[name]
            per_mode = np.mean([ms for _, ms in r], axis=0)
            print(f"{t} {name}: 19 launches {' / '.join(f'{s:.4f}' for s, _ in r)} ms, per-mode "
                  f"sum {per_mode.sum():.4f} ms; mode:ms (one launch)/registers/spill bytes/SASS "
                  + " ".join(f"{m}:{per_mode[m]:.4f}/{ptxas[(t, m)]['registers']}/{ptxas[(t, m)]['spill_stores']}/"
                             f"{sass[(t, m)]}" for m in range(19)))
        for name, r in tile_runs.items():
            _, ptxas, sass = variants[name]
            reg = ptxas.get((t, "tiles"), {})
            print(f"{t} {name} tiles: one launch, tiled cell {' / '.join(f'{a:.4f}' for a, _ in r)} ms, shuffled "
                  f"{' / '.join(f'{b:.4f}' for _, b in r)} ms; {reg.get('registers')} registers, "
                  f"{reg.get('spill_stores')} B spill stores, {tiles_warps(variants[name][0], t)} warps/SM, "
                  f"{sass.get((t, 'tiles'))} SASS")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
