#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card: UASTC (to BC7, ASTC,
RGBA, ETC1 and ETC2, for blocks and for .basis files) and ETC1S (to RGBA and
ETC1, for index streams and for .basis files).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. card facts (nvidia-smi name and power limit, torch and CUDA versions);
  2. nvcc build of csrc/*.cu for sm_90a (one nvcc per source, in parallel),
     with seconds and the ptxas register/spill report of all 201 kernels
     (K1 BC7, K2 ASTC, K3 RGBA, K4 ETC1, K5 ETC2, x 19 UASTC modes; K1's
     tile kernel; K6-K9, the four ETC1S kinds; the 100 T1 stage kernels;
     the probe P); for K1-K5
     per mode also the resident warps per SM (the CUDA runtime's occupancy
     calculator) and the static SASS instruction count (cuobjdump -sass of
     the built library), and 0 B of spills required of K1-K5;
  3. per UASTC mode 0-18: the BC7 kernel against its plain PyTorch version
     on the card, on that mode's golden blocks plus 65,536 seeded random
     blocks of the mode (invalid pattern indices included), with and
     without an index list, bit-exact;
  4. the golden corpus through `transcode_uastc_blocks(..., device="cuda")`
     to BC7, plus an invalid-mode and an invalid-pattern block that must set
     err;
  5. the BC7 main path at full size: 2^23 device-resident blocks of the
     golden all-mode mix through `transcode_uastc_blocks`, checked against
     the tiled golden outputs, with launch counters that must show one
     tile-kernel launch (phases 8 and 12: one launch per mode) and no
     plain-version call; then CUDA-event timings of the whole call, of its
     one tile-kernel launch (device time), of the per-mode path's 19
     launches alone (as the dispatch sends another target's; as called, and
     device time with the stream preloaded), of each mode's kernel on its
     group (one launch, device time; their sum beside the 19 launches'
     span), and of the plain version at the same size (as called).  The
     call's output and err, and the output of the 19 launches alone, are
     checked with no synchronize before the check;
  6. as phase 3, for the ASTC and RGBA kernels;
  7. the golden corpus to ASTC and RGBA through the API on the card, and the
     invalid-mode and invalid-pattern blocks through the block functions,
     which must raise the reference's messages;
  8. as phase 5, for ASTC (128 MiB in, 128 MiB out) and RGBA (128 MiB in,
     512 MiB out); K3's 19 launches are also run and timed with each mode's
     index randomly permuted (the scatter of real files), bit-exact against
     the tiled golden outputs;
  9. the file path at full size: a UASTC .basis texture array of 8 slices of
     4096x4096 texels (2^23 blocks) written by the port's writer, read by
     `read_to_bc7`, `read_to_astc` and `read_to_rgba` and checked image by
     image (raster order for RGBA), with the launch counters of each call,
     the time split of one call, and a corrupt-CRC file and a file with
     invalid blocks that must raise the reference's messages;
 10. as phase 3, for the ETC1 and ETC2 kernels;
 11. as phase 7, for ETC1 and ETC2 (`transcode_uastc_block_to_etc1/etc2`);
 12. as phase 5, for ETC1 (128 MiB in, 64 MiB out) and ETC2 (128 MiB in,
     128 MiB out);
 13. as phase 9, for `read_to_etc1` and `read_to_etc2` on the same file;
 14. K6-K9 (ETC1S rgba, alpha, rgba_alpha, etc1) against their plain
     versions on the card, bit-exact, on seeded codebooks of 2,048, 16,128
     and 65,535 entries and of one entry, each over 65,536 blocks;
 15. the ETC1S block main path at full size: 2^23 device-resident blocks of
     seeded uint16 index streams into codebooks of 2,048 entries, through
     `run_etc1s_rgba` (K6), `run_etc1s_rgba` with an alpha pass (K8), K7's
     wrapper alone and `run_etc1s_etc1` (K9), each bit-exact against its
     plain version with one launch and no plain call; then CUDA-event
     timings of the whole call, of the launch (as called, and device time
     with the stream preloaded) and of the plain version;
 16. the ETC1S file path at full size, files written by the port's writer:
     a texture array of 8 slices of 1024x1024 blocks and a file of 4 RGB +
     alpha slice pairs of 1024x1024 blocks, each read by `read_to_rgba` (K6,
     K8) and `read_to_etc1` (K9) image by image against the plain version
     on the writer's index streams, with one launch per file, the time
     split of one call, and a corrupt-CRC file and an odd-slice alpha file
     that must raise the reference's messages;
 17. P, the fl_div255 probe: the device `ub::fl_div255` on x = 0..255, bit-
     equal to IEEE x/255, and on 0..65,535 against the two-roundings formula
     (for the record: how many of those differ from IEEE x/255), timed;
 18. T1, the 100 K1 stage kernels (bc7_stage_kernel<M, S>) against their
     plain versions per (mode, stage), on that mode's golden blocks plus
     65,536 seeded random blocks of the mode, bit-exact;
 19. T1 timing: the stage tool (`basisu_rs_tpu_torch.tools.ablate_bc7`)
     over all 19 modes at its own input (131,072 blocks a mode), device
     time, Mblocks/s and HBM bound per (mode, stage), the checksums of each
     timed launch against the plain version on the same blocks, bit-exact,
     and the plain version's time (mode 1's permute_invert, which the tool
     leaves out as the TPU tool does, timed beside it through the tool's
     `time_stage`); then per mode, on the same 2^23 blocks of that mode,
     every stage the tool times (checked against the plain version) and K1
     (checked against the golden outputs) timed, the `full` stage and the
     other stages set against K1, with K1's phase-5 time beside them, and
     for the multi-subset modes the permute/invert step alone
     (permute_invert - decode_fields) as a share of full; each stage's
     2^23-block time beside its bound, the larger of its HBM bound and its
     issue bound (2^23 / 32 warps x phase 2's SASS count of the stage
     kernel over 132 SMs x 4 issue slots at the maximum SM clock, as phase
     23), per mode and summed over the modes;
 20. the corpus transcoders at full size: 24 mip-chained 2048x2048 UASTC
     textures (8,388,600 blocks in 240 slices) through CorpusTranscoder
     (bc7, rgba) and UastcTranscoder.transcode_async + gather, bit-exact
     against transcode_uastc_blocks, at most 19 launches a call, timed at
     three corpus sizes (~2^19, ~2^21, ~2^23 blocks); 64 ETC1S files of
     2,048-entry codebooks (2^23 blocks) through Etc1sMultiCorpusTranscoder
     (rgba, etc1, one resident run) against per-file Etc1sCorpusTranscoder
     runs, 2 launches a target (the 65,536-entry cap), timed;
 21. the corpus pipeline: 64 mip-chained 1024x1024 UASTC files, 16 ETC1S
     files (8 with alpha slices) and one corrupt file on disk, written by
     the port's writers, through BasisCorpusPipeline (workers 1 and 4) and
     an inline read_to_rgba loop, images bit-exact across the three, the
     corrupt file in `errors` with the reference's message, a resume that
     skips the files done, all three timed;
 22. the CLI on the card: `python -m basisu_rs_tpu_torch selftest` as a
     subprocess, `info` of a file, and `transcode --container ktx2|ktx|png`
     whose files equal the writers applied to the readers' output;
 23. K1-K5 per mode on 2^23 contiguous blocks of that mode (its
     golden blocks tiled, no index), each output bit-exact against the
     tiled golden outputs, timed beside its HBM bound and its issue bound
     (2^23 / 32 warps x phase 2's SASS count over 132 SMs x 4 issue slots
     at the maximum SM clock), so the launch ramp of the main path's
     ~441,500-block launches is apart from the steady rate;
 24. the sharded path (`basisu_rs_tpu_torch.parallel`): (a) `make_mesh(1)`
     through `sharded_transcode` on phase 5's 2^23 blocks for the five
     targets, bit-exact against the single-device `transcode_blocks`, 19
     launches and no plain call a target, the whole call timed beside the
     single-device call (single, mesh, mesh, single) and the launches'
     device time; (b) four shards on the one card (`[cuda:0] * 4`) over
     2^23 + 3 blocks with an invalid-mode block in the third shard and an
     invalid-pattern block in the fourth, out and err equal to the
     single-device path, and files holding those blocks raising the first
     failing block's message through `read_to_bc7(buf, mesh=...)`; (c)
     `sharded_etc1s_transcode` for the four kinds on phase 15's inputs, on
     both meshes, equal to the single-device entries; (d)
     `read_to_{bc7,rgba,etc1}` of phase 9's file and `read_to_{rgba,etc1}`
     of phase 16's files with `mesh=`, images bit-exact against the reads
     without one; (e) the CLI's `transcode --mesh 1` writing the bytes of
     the unsharded run, and `--mesh N` past the card count exiting with rc
     2 and the mesh's message; (f) with two or more cards, (a) and (c) on
     `make_mesh(2)` and on every card as well;
 25. the port's benchmark, `python -m basisu_rs_tpu_torch.bench`, as a
     subprocess at its default size (2^23 blocks, BENCH_FAST unset) under
     a timeout: exit code 0, a last line that parses with every key of the
     JAX system's bench.py line but vs_baseline (`bench.LINE_KEYS`) and
     `device`, every rate finite and above 0, `device.name` the card's
     name; the line and the bench's stderr are printed;
 26. K1 in one launch (`kernels.tile_kernel("bc7")`, uastc_kernel_tiles<Bc7>)
     against the per-mode path (the partition and 19 launches), out and err
     byte for byte, on 2^23 blocks of the resident cell's shuffled mix, a
     mix of runs of one mode, 2^23 - 7 shuffled blocks and a shuffled batch
     with invalid-mode, invalid-pattern and random blocks; for each its
     device time beside the 33-byte HBM bound and the per-mode path's
     launches, the whole call, its warp-rounds and lane share (the
     recorder's `tile_warp_rounds`); then phase 5's tiled golden mix
     (== golden), the per-mode kernels over contiguous blocks of one mode
     (phase 23's measure), and the kernel's registers, resident warps and
     SASS count.
Phases 17-26 print their seconds.  `python3 chip_smoke.py --phase 24`
(or `--phase 25`, `--phase 26`) runs phase 1, the build and that phase
alone, phase 24 on inputs built as the full run builds them.
The last two lines before the final one are a JSON line of per-kernel
results and the card's name and power limit; the final line is the
`{"ok": true, "device": ...}` result.  Imports torch, numpy and
basisu_rs_tpu_torch only.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from basisu_rs_tpu_torch.utils.profiling import HBM_BYTES_PER_S, event_times_ms

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_blocks.npz"
N_FULL = 1 << 23
N_RANDOM = 1 << 16
SEED = 0
REPS = 10
PLAIN_REPS = 5
FILE_REPS = 3
TEXELS_PER_BLOCK = 16
INDEX_BYTES = 8  # the dispatch's int64 index of a block, read once by its launch
TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")
OP_NAME = {"bc7": "Bc7", "astc": "Astc", "rgba": "Rgba", "etc1": "Etc1", "etc2": "Etc2"}
REPLACES = "basisu_rs_tpu/ops/pallas_kernels.py:150"
SLICES, SLICE_BLOCKS_X = 8, 1024  # 8 slices of 1024x1024 blocks = 2^23 blocks
ETC1S_SIZES = (2048, 16128, 65535, 1)  # phase 14's codebook entries (E = S)
ETC1S_BOOK = 2048  # E = S of phases 15 and 16 (bench.py:183)
ETC1S_INDEX_BYTES = 2  # a uint16 index, read once by the launch
ETC1S_REPLACES = "basisu_rs_tpu/ops/etc1s_pallas.py:230"
T1_REPLACES = "tools/ablate_bc7.py:58"
T1_CLOSURES = {"full": 126, "decode_endpoints": 130, "decode_weights": 134, "decode_fields": 139, "pbit": 143,
               "permute_invert": 154}  # each stage's closure in tools/ablate_bc7.py
T1_BLOCK_BYTES = 20  # a stage kernel reads a 16-byte block and writes a 4-byte checksum
T1_BIG = 1 << 23  # phase 19's second size, blocks a mode: far above the launch floor
PROBE_REPLACES = "tests/test_pbits.py:73, tests/test_tpu_hardware.py:80"
PROBE_N = 1 << 16
PROBE_BYTES = 8  # an int32 in, a float32 out
CORPUS_SIZES = ((6, 1024), (6, 2048), (24, 2048))  # (textures, width): ~2^19, ~2^21, ~2^23 blocks
ETC1S_FILES, ETC1S_FILE_SLICES = 64, 2  # phase 20: 64 files x 2 slices x 65,536 blocks = 2^23
PIPE_UASTC, PIPE_ETC1S, PIPE_WIDTH = 64, 16, 1024  # phase 21's corpus
KERNEL_THREADS = 256  # threads a CTA of the UASTC kernels (csrc/uastc_decode.cuh kThreads)
ISSUE_SLOTS = 4  # warp instructions an SM issues a cycle (four schedulers)
BENCH_TIMEOUT_S = 600  # phase 25's subprocess


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_launches(kernels, t: str, calls: int, label: str) -> tuple:
    """Require the launches since kernels.reset_counts() of `calls` calls of
    target t's main path: one tile-kernel launch a call and no per-mode
    launch for a target in kernels.TILED (BC7), else one launch per mode a
    call; returns (launches of each mode's kernel [19], tile-kernel
    launches)."""
    modes, tiles = kernels.launch_counts()[t], kernels.tile_launch_counts().get(t, 0)
    want = ([0] * 19, calls) if t in kernels.TILED else ([calls] * 19, 0)
    require((modes, tiles) == want, f"{label} {t}: launches per mode {modes}, tile-kernel launches {tiles}, "
                                    f"expected {want}")
    return modes, tiles


def launch_text(kernels, t: str, counted: tuple) -> str:
    """check_launches' (per-mode, tile-kernel) counts as the phases print them."""
    modes, tiles = counted
    return f"tile-kernel launches {tiles}" if t in kernels.TILED else f"launches per mode {modes}"


def card_facts() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def times_ms(fn, reps: int = REPS, preload: bool = False) -> list:
    """fn's time between two CUDA events, in ms, for each of `reps` runs: as
    called, or with preload=True the device's own time (event_times_ms)."""
    return event_times_ms(fn, reps, preload=preload)


def median_ms(fn, reps: int = REPS, preload: bool = False) -> float:
    return statistics.median(times_ms(fn, reps, preload))


def host_ms(fn, reps: int = FILE_REPS) -> float:
    """Median host-clock time of fn followed by a device sync, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mtex(n_blocks: int, ms: float) -> float:
    return n_blocks * TEXELS_PER_BLOCK / (ms * 1e-3) / 1e6


def mode_blocks(rng, lut, golden_in, mode: int) -> np.ndarray:
    """The mode's golden blocks plus N_RANDOM random blocks whose first byte
    is drawn from the codes of that mode (random pattern fields include
    out-of-range ones)."""
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (N_RANDOM, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, N_RANDOM)
    gold = golden_in[lut[golden_in[:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


def etc1s_codebooks(rng, e: int, s: int):
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    return endpoints, rng.integers(0, 256, (s, 4)).astype(np.uint8)


def tiled_blocks(golden_in: np.ndarray) -> np.ndarray:
    """Phase 5's input: the golden all-mode mix tiled to N_FULL blocks."""
    return np.tile(golden_in, (-(-N_FULL // len(golden_in)), 1))[:N_FULL]


def invalid_blocks() -> np.ndarray:
    """uint8 [2, 16]: an invalid-mode block (byte 0 = 69, MODE_LUT value 19)
    and a mode-2 block whose pattern field is 31 (mode 2 has 30 patterns)."""
    from basisu_rs_tpu_torch.tables import MODES

    bad = np.zeros((2, 16), np.uint8)
    bad[0, 0] = 69
    bad[1, 0] = 0x1D
    ofs = MODES[2].field_offsets["pattern"]
    for b in range(5):
        bad[1, (ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    return bad


def uastc_texture_slices(full_np: np.ndarray) -> list:
    """Phase 9's file: SLICES slices of SLICE_BLOCKS_X² blocks of full_np, as
    the port's writer takes them."""
    per_slice = SLICE_BLOCKS_X * SLICE_BLOCKS_X
    return [
        dict(blocks=full_np[i * per_slice : (i + 1) * per_slice], nbx=SLICE_BLOCKS_X, nby=SLICE_BLOCKS_X,
             orig_width=4 * SLICE_BLOCKS_X, orig_height=4 * SLICE_BLOCKS_X, image_index=0, level_index=0)
        for i in range(SLICES)
    ]


def etc1s_streams():
    """(endpoints, selectors, four uint16 index streams of N_FULL blocks):
    phases 15 and 16's seeded ETC1S inputs, codebooks of ETC1S_BOOK entries."""
    rng = np.random.default_rng(SEED + 1)
    endpoints, selectors = etc1s_codebooks(rng, ETC1S_BOOK, ETC1S_BOOK)
    return endpoints, selectors, [rng.integers(0, ETC1S_BOOK, N_FULL).astype(np.uint16) for _ in range(4)]


def etc1s_slice(ep, sel, alpha=False) -> dict:
    """One SLICE_BLOCKS_X² ETC1S slice of the given index streams, as the
    port's writer takes it."""
    w = 4 * SLICE_BLOCKS_X
    return dict(ep_idx=ep, sel_idx=sel, nbx=SLICE_BLOCKS_X, nby=SLICE_BLOCKS_X, orig_width=w, orig_height=w,
                alpha=alpha)


def etc1s_file_layout() -> dict:
    """Phase 16's two files as {name: [(endpoint stream, selector stream,
    slice j of those streams, alpha slice?)]}: "array", 8 slices of idx[0],
    idx[1]; "alpha", 4 (RGB, alpha) pairs, RGB from idx[0], idx[1], alpha
    from idx[2], idx[3], over the first 4 slices."""
    return {
        "array": [(0, 1, j, False) for j in range(SLICES)],
        "alpha": [(a, b, j, alpha) for j in range(SLICES // 2) for a, b, alpha in ((0, 1, False), (2, 3, True))],
    }


def etc1s_texture_files(endpoints, selectors, idx_np) -> dict:
    """Phase 16's two N_FULL-block files (etc1s_file_layout): {name:
    (bytes, slice count, seconds to write)}."""
    from basisu_rs_tpu_torch.container.writer import write_etc1s_basis

    per = SLICE_BLOCKS_X * SLICE_BLOCKS_X
    files = {}
    for name, spec in etc1s_file_layout().items():
        t0 = time.perf_counter()
        sl = [etc1s_slice(idx_np[a][j * per:(j + 1) * per], idx_np[b][j * per:(j + 1) * per], alpha)
              for a, b, j, alpha in spec]
        buf = write_etc1s_basis(endpoints, selectors, sl, has_alpha=name == "alpha")
        files[name] = (buf, len(spec), time.perf_counter() - t0)
    return files


def pipeline_corpus(tmp: Path, full_np, endpoints, selectors) -> tuple:
    """Phase 21's corpus written into tmp: PIPE_UASTC UASTC mip chains of
    full_np, PIPE_ETC1S ETC1S files (every second with alpha slices), and a
    corrupt copy of the second file at position 40.  (paths, corrupt
    path)."""
    from basisu_rs_tpu_torch.container.writer import write_etc1s_basis, write_uastc_basis

    rng = np.random.default_rng(SEED + 4)
    paths = []
    ofs = 0
    for f in range(PIPE_UASTC):
        chain = mip_slices(full_np, 1, PIPE_WIDTH, ofs)
        ofs += sum(len(s) for _, _, s in chain)
        buf = write_uastc_basis([dict(blocks=s, nbx=nb, nby=nb, orig_width=4 * nb, orig_height=4 * nb,
                                      image_index=0, level_index=lvl) for lvl, nb, s in chain])
        paths.append(tmp / f"u{f:02d}.basis")
        paths[-1].write_bytes(buf)
    nb = PIPE_WIDTH // 4
    for f in range(PIPE_ETC1S):
        alpha = f % 2 == 1
        sl = [dict(ep_idx=rng.integers(0, ETC1S_BOOK, nb * nb).astype(np.uint16),
                   sel_idx=rng.integers(0, ETC1S_BOOK, nb * nb).astype(np.uint16), nbx=nb, nby=nb,
                   orig_width=PIPE_WIDTH, orig_height=PIPE_WIDTH, alpha=a) for a in ((False, True) if alpha else (False,))]
        paths.append(tmp / f"e{f:02d}.basis")
        paths[-1].write_bytes(write_etc1s_basis(endpoints, selectors, sl, has_alpha=alpha))
    corrupt = bytearray(paths[1].read_bytes())
    corrupt[-100] ^= 0x01
    bad = tmp / "corrupt.basis"
    bad.write_bytes(bytes(corrupt))
    paths.insert(40, bad)
    return paths, bad


def etc1s_tables(etc1s, endpoints, selectors, kind: str, dev):
    """The packed codebooks of `kind` on the card: endpoint words, and
    selector words (wire words for "etc1")."""
    words = etc1s.selector_wire_words(selectors) if kind == "etc1" else etc1s.pack_selectors(selectors)
    return etc1s.codebook_tensor(etc1s.pack_endpoints(endpoints), dev), etc1s.codebook_tensor(words, dev)


def etc1s_block_bytes(etc1s, kind: str) -> int:
    """HBM bytes the function needs a block: its uint16 indices read once,
    its output written once (the codebooks stay cached)."""
    return ETC1S_INDEX_BYTES * len(etc1s.INDEX_BOOKS[kind]) + etc1s.OUT_BYTES[kind]


def etc1s_kernel_vs_plain(etc1s, dev, card: str) -> dict:
    """Phase 14: K6-K9 against their plain versions on the card, at every
    codebook size of ETC1S_SIZES; returns {kind: max abs byte difference}."""
    rng = np.random.default_rng(SEED)
    worst = {k: 0 for k in etc1s.KINDS}
    for e in ETC1S_SIZES:
        endpoints, selectors = etc1s_codebooks(rng, e, e)
        idx = [torch.from_numpy(rng.integers(0, e, N_RANDOM).astype(np.uint16)).to(dev) for _ in range(4)]
        for kind in etc1s.KINDS:
            ep_tab, sel_tab = etc1s_tables(etc1s, endpoints, selectors, kind, dev)
            streams = idx[: len(etc1s.INDEX_BOOKS[kind])]
            k_out = etc1s.etc1s_kernel(kind)(ep_tab, sel_tab, *streams)
            p_out = torch.empty_like(k_out)
            etc1s.PLAIN[kind](ep_tab, sel_tab, streams, p_out)
            torch.cuda.synchronize()
            diff = int((k_out.to(torch.int32) - p_out.to(torch.int32)).abs().max())
            require(diff == 0, f"ETC1S {kind}, {e}-entry codebooks: kernel differs from the plain version "
                               f"(max byte diff {diff})")
            worst[kind] = max(worst[kind], diff)
        print(f"phase 14 etc1s E = S = {e}: {N_RANDOM} blocks, kernel == plain for "
              + ", ".join(etc1s.KINDS) + f" (tolerance 0, max abs err 0) [{card}]")
    return worst


def etc1s_main_path(etc1s, dev, card: str, endpoints, selectors, idx) -> dict:
    """Phase 15: the ETC1S block main path at N_FULL blocks, each kind
    bit-exact against its plain version with one launch, then timed;
    returns {kind: {launches, max_abs_err, ms, plain_ms}}."""
    tables = {k: etc1s_tables(etc1s, endpoints, selectors, k, dev) for k in etc1s.KINDS}
    calls = {
        "rgba": lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1]),
        "rgba_alpha": lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], (idx[2], idx[3])),
        # K7 has no entry of its own (the file path fuses it into K8): its wrapper
        "alpha": lambda: etc1s.etc1s_kernel("alpha")(*tables["alpha"], idx[0], idx[1]),
        "etc1": lambda: etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1]),
    }
    results = {}
    for kind in ("rgba", "rgba_alpha", "alpha", "etc1"):
        streams = idx[: len(etc1s.INDEX_BOOKS[kind])]
        calls[kind]()  # warm-up (library load, allocator)
        torch.cuda.synchronize()
        etc1s.reset_counts()
        out = calls[kind]()
        torch.cuda.synchronize()
        launches, plain_calls = etc1s.launch_counts(), etc1s.plain_call_counts()
        p_out = torch.empty(N_FULL, etc1s.OUT_BYTES[kind], dtype=torch.uint8, device=dev)
        etc1s.PLAIN[kind](*tables[kind], streams, p_out)
        got = out.view(torch.uint8)
        require(tuple(got.shape) == tuple(p_out.shape) and got.device == dev, f"{kind} output shape/device")
        require(bool(torch.equal(got, p_out)), f"ETC1S {kind} main path differs from the plain version")
        require(launches == {k: int(k == kind) for k in etc1s.KINDS}, f"ETC1S {kind} launch counts {launches}")
        require(sum(plain_calls.values()) == 0, f"plain version called on the ETC1S main path: {plain_calls}")
        print(f"phase 15 etc1s {kind} main path: {N_FULL} blocks bit-exact vs the plain version; launches "
              f"{launches[kind]}; plain-version calls 0 [{card}]")
        del out, got

        k_out = torch.empty_like(p_out)

        def launch_alone():
            etc1s.etc1s_kernel(kind)(*tables[kind], *streams, out=k_out, check_index=False)

        call_times = times_ms(calls[kind])
        call_ms = statistics.median(call_times)
        q1, _, q3 = statistics.quantiles(call_times, n=4)
        launch_ms = median_ms(launch_alone)
        dev_ms = median_ms(launch_alone, preload=True)
        plain_ms = median_ms(lambda: etc1s.PLAIN[kind](*tables[kind], streams, p_out), PLAIN_REPS)
        del k_out, p_out
        torch.cuda.empty_cache()
        nbytes = etc1s_block_bytes(etc1s, kind)
        bound = N_FULL * nbytes / HBM_BYTES_PER_S * 1e3
        print(f"phase 15 etc1s {kind} time [{card}]: whole call {call_ms:.4f} ms = {mtex(N_FULL, call_ms):.1f} "
              f"Mtexels/s (median of {REPS}, CUDA events; quartiles {q1:.4f}-{q3:.4f} ms); launch as called "
              f"{launch_ms:.4f} ms; device time {dev_ms:.4f} ms = {mtex(N_FULL, dev_ms):.1f} Mtexels/s; HBM bound "
              f"{bound:.4f} ms ({nbytes} B a block at 3.35 TB/s, {100 * bound / dev_ms:.1f}% of device time); plain "
              f"PyTorch version {plain_ms:.4f} ms (as called, median of {PLAIN_REPS})")
        results[kind] = dict(launches=launches[kind], ms=dev_ms, plain_ms=plain_ms)
    return results


def etc1s_file_path(etc1s, basis, readers, dev, card: str, endpoints, selectors, idx_np, idx) -> None:
    """Phase 16: two full-size ETC1S files through read_to_rgba and
    read_to_etc1, image by image against the plain version on the writer's
    index streams, one launch a file, with the time split of one call."""
    from basisu_rs_tpu_torch.container.writer import write_etc1s_basis

    per = SLICE_BLOCKS_X * SLICE_BLOCKS_X
    w = 4 * SLICE_BLOCKS_X
    files = {}
    for name, (buf, n_slices, seconds) in etc1s_texture_files(endpoints, selectors, idx_np).items():
        files[name] = buf
        print(f"phase 16 file {name}: {n_slices} slices of {w}x{w} texels, {len(buf)} bytes, written in "
              f"{seconds:.2f} s (host)")

    tables = {k: etc1s_tables(etc1s, endpoints, selectors, k, dev) for k in etc1s.KINDS}

    def plain_out(kind, streams):
        out = torch.empty(streams[0].shape[0], etc1s.OUT_BYTES[kind], dtype=torch.uint8, device=dev)
        etc1s.PLAIN[kind](*tables[kind], streams, out)
        return out

    layout = etc1s_file_layout()

    def check_images(name, reader_name, images):
        spec = layout[name]
        if reader_name == "rgba":
            pairs = name == "alpha"
            rgb = [s for s in spec if not s[3]]
            require(len(images) == len(rgb), f"{name} rgba: {len(images)} images")
            for img, (a, b, j, _) in zip(images, rgb):
                rows = slice(j * per, (j + 1) * per)
                streams = [idx[a][rows], idx[b][rows]] + ([idx[2][rows], idx[3][rows]] if pairs else [])
                exp = plain_out("rgba_alpha" if pairs else "rgba", streams).view(torch.int32)
                require((img.w, img.h, img.stride) == (w, w, 16 * SLICE_BLOCKS_X), f"{name} rgba image geometry")
                # raster rows -> [by, bx, y, x] texels: the inverse of the reader's reorder
                got = img.data.view(torch.int32).view(SLICE_BLOCKS_X, 4, SLICE_BLOCKS_X, 4).permute(0, 2, 1, 3)
                require(bool(torch.equal(got.reshape(-1, 16), exp)), f"{name} rgba image {j} differs from plain")
        else:
            require(len(images) == len(spec), f"{name} etc1: {len(images)} images")
            for img, (a, b, j, _) in zip(images, spec):
                rows = slice(j * per, (j + 1) * per)
                exp = plain_out("etc1", [idx[a][rows], idx[b][rows]]).reshape(-1)
                require((img.w, img.h, img.stride) == (w, w, 8 * SLICE_BLOCKS_X), f"{name} etc1 image geometry")
                require(bool(torch.equal(img.data, exp)), f"{name} etc1 image {j} differs from plain")

    for name, buf in files.items():
        for reader_name, reader in readers.items():
            kind = {"rgba": "rgba_alpha" if name == "alpha" else "rgba", "etc1": "etc1"}[reader_name]
            reader(buf)  # warm-up
            torch.cuda.synchronize()
            etc1s.reset_counts()
            images = reader(buf)
            torch.cuda.synchronize()
            launches, plain_calls = etc1s.launch_counts(), etc1s.plain_call_counts()
            require(launches == {k: int(k == kind) for k in etc1s.KINDS}, f"{name} {reader_name} launches {launches}")
            require(sum(plain_calls.values()) == 0, f"plain version called on the ETC1S file path: {plain_calls}")
            check_images(name, reader_name, images)
            del images

            header, descs = basis._validated(buf)
            pairs = reader_name == "rgba" and header.has_alpha
            dec = basis.make_etc1s_decoder(header, buf)
            host, slices = basis.etc1s_index_streams(buf, dec, descs, pairs)
            t = torch.from_numpy(host).to(dev)
            if reader_name == "rgba":
                alpha_pass = (t[2], t[3]) if pairs else None

                def kernel():
                    return etc1s.run_etc1s_rgba(dec.endpoints, dec.selectors, t[0], t[1], alpha_pass, dev,
                                                check_index=False)
            else:

                def kernel():
                    return etc1s.run_etc1s_etc1(dec.endpoints, dec.selectors, t[0], t[1], dev, check_index=False)

            out = kernel()
            split = {
                "header + CRC, host": host_ms(lambda: basis._validated(buf)),
                "codebook decode, host": host_ms(lambda: basis.make_etc1s_decoder(header, buf)),
                "slice front-end (C++), host": host_ms(lambda: basis.etc1s_index_streams(buf, dec, descs, pairs)),
                "H2D copy of the indices": host_ms(lambda: torch.from_numpy(host).to(dev)),
                "kernel": host_ms(kernel),
            }
            if reader_name == "rgba":
                split["RGBA reorder"] = host_ms(lambda: basis.rgba_images(out, slices))
            split["whole call"] = host_ms(lambda: reader(buf))
            blocks = host.shape[1] * (2 if pairs else 1)  # blocks through the front-end
            del out, t
            torch.cuda.empty_cache()
            print(f"phase 16 {name} read_to_{reader_name} [{card}]: {len(slices)} images bit-exact vs the plain "
                  f"version; launches {launches[kind]} ({kind}); plain-version calls 0")
            print(f"phase 16 {name} read_to_{reader_name} split [{card}] (host clock + sync, median of {FILE_REPS}, "
                  f"ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                  + f"; front-end {1e6 * split['slice front-end (C++), host'] / blocks:.2f} ns a block over "
                  f"{blocks} blocks; whole call {mtex(host.shape[1], split['whole call']):.1f} Mtexels/s")

    corrupt = bytearray(files["array"])
    corrupt[-1000] ^= 0x10
    odd = write_etc1s_basis(endpoints, selectors, [etc1s_slice(idx_np[0][:per], idx_np[1][:per]),
                                                   etc1s_slice(idx_np[2][:per], idx_np[3][:per], True),
                                                   etc1s_slice(idx_np[0][per:2 * per], idx_np[1][per:2 * per])],
                            has_alpha=True)
    for label, buf, msg in (("corrupt CRC", bytes(corrupt), "Data CRC16 failed"),
                            ("odd-slice alpha", odd, "File has alpha, but slice count is odd")):
        for reader_name, reader in readers.items():
            try:
                reader(buf)
            except basis.BasisError as e:
                require(str(e) == msg, f"{label} via read_to_{reader_name}: message {e!r}, expected {msg!r}")
            else:
                raise RuntimeError(f"{label} ETC1S file accepted by read_to_{reader_name}")
    print(f"phase 16 errors: a corrupt-CRC ETC1S file and an odd-slice alpha file raise the reference's messages "
          f"through read_to_rgba/read_to_etc1 [{card}]")
    return files


def probe_phase(dev, card: str) -> dict:
    """Phase 17: the fl_div255 probe P on the card."""
    from basisu_rs_tpu_torch.ops import fl_div255_probe as probe

    x = torch.arange(PROBE_N, dtype=torch.int32, device=dev)
    p = probe.fl_div255
    p(x)  # warm-up
    torch.cuda.synchronize()
    p.launches = p.plain_calls = 0
    small, full = p(x[:256]), p(x)
    torch.cuda.synchronize()
    launches, plain_calls = p.launches, p.plain_calls
    require(launches == 2 and plain_calls == 0, f"probe launches {launches}, plain calls {plain_calls}")
    ieee = np.arange(256, dtype=np.float32) / np.float32(255)
    got = small.cpu().numpy()
    require(np.array_equal(got.view(np.int32), ieee.view(np.int32)), "fl_div255 on the card differs from IEEE x/255")
    plain = probe.plain(x[:256]).cpu().numpy()
    require(np.array_equal(plain.view(np.int32), ieee.view(np.int32)), "the plain probe on the card is not IEEE x/255")
    got_full = full.cpu().numpy().view(np.int32)
    formula = probe.two_roundings_np(np.arange(PROBE_N)).view(np.int32)
    require(np.array_equal(got_full, formula), "fl_div255 on the card differs from the two-roundings formula")
    n_ieee = int((got_full != (np.arange(PROBE_N, dtype=np.float32) / np.float32(255)).view(np.int32)).sum())
    # a 0-dim tensor divisor: with a Python scalar, CUDA multiplies by its reciprocal
    t255 = torch.tensor(255.0, device=dev)
    library = torch.div(x[:256], t255).cpu().numpy()
    require(np.array_equal(library.view(np.int32), ieee.view(np.int32)),
            "torch.div(x, torch.tensor(255.0)) is not IEEE x/255")
    by_scalar = torch.div(x[:256], 255.0).cpu().numpy()
    print(f"phase 17 probe record [{card}]: torch.div(x, 255.0) with a Python scalar differs from IEEE x/255 at "
          f"{int((by_scalar.view(np.int32) != ieee.view(np.int32)).sum())} of x = 0..255")
    out = torch.empty_like(full)
    ms = median_ms(lambda: p(x, out), preload=True)
    plain_ms = median_ms(lambda: probe.plain(x))
    library_ms = median_ms(lambda: torch.div(x, t255))
    bound = PROBE_N * PROBE_BYTES / HBM_BYTES_PER_S * 1e3
    print(f"phase 17 probe [{card}]: fl_div255 on the card == IEEE x/255 for x = 0..255 (tolerance 0, max abs "
          f"err 0); launches {launches}, plain-version calls 0")
    print(f"phase 17 probe record [{card}]: x = 0..{PROBE_N - 1}: equal to the two-roundings formula everywhere; "
          f"{n_ieee} of {PROBE_N} values differ from IEEE x/255 (the identity is claimed for 0..255 only)")
    print(f"phase 17 probe time [{card}]: {PROBE_N} values, device time {ms:.4f} ms; HBM bound {bound:.6f} ms "
          f"({PROBE_BYTES} B a value); plain x.float() / 255 {plain_ms:.4f} ms, one "
          f"torch.div(x, torch.tensor(255.0)) {library_ms:.4f} ms (as called, median of {REPS})")
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound)


def stages_vs_plain(bc7_stages, dev, card: str, lut, golden_in) -> None:
    """Phase 18: every T1 kernel against its plain version on the card, on
    golden and seeded random blocks (invalid patterns included)."""
    rng = np.random.default_rng(SEED + 2)
    bc7_stages.reset_counts()
    for m in range(19):
        blocks = torch.from_numpy(mode_blocks(rng, lut, golden_in, m)).to(dev)
        stages = [s for s in bc7_stages.STAGES if m in bc7_stages.STAGE_MODES[s]]
        for stage in stages:
            k_out = bc7_stages.stage_kernel(m, stage)(blocks)
            p_out = torch.empty_like(k_out)
            bc7_stages.stage_rows(m, stage, blocks, p_out)
            torch.cuda.synchronize()
            diff = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max())
            require(diff == 0, f"T1 mode {m} {stage}: kernel differs from the plain version ({diff})")
        print(f"phase 18 T1 mode {m:2d}: {blocks.shape[0]} blocks, kernel == plain for {', '.join(stages)} "
              f"(tolerance 0, max abs err 0) [{card}]")
    plain_calls = sum(bc7_stages.plain_call_counts().values())
    require(plain_calls == 0, f"plain version called through the T1 wrappers on the card: {plain_calls}")


def stages_timing(bc7_stages, kernels, dev, card: str, k1_mode_ms: dict, k1_counts, golden_in,
                  golden_bc7, sass) -> dict:
    """Phase 19: the T1 tool over all 19 modes at its own input (the golden
    blocks tiled 4096 times, split by mode), each kernel held against its
    plain version on the blocks it was timed on; then, for each mode, every
    stage and K1 timed on the same T1_BIG blocks of that mode, a size at
    which the launch floor no longer hides the split of K1's time, each
    stage's time beside its bound: the larger of its HBM bound and its
    issue bound from `sass` (phase 2's SASS counts), as phase 23 reads
    K1-K5."""
    from basisu_rs_tpu_torch.ops.dispatch import block_modes
    from basisu_rs_tpu_torch.tools import ablate_bc7

    inputs = ablate_bc7.mode_blocks(range(19), dev)
    bc7_stages.reset_counts()

    def log(line):
        print(f"phase 19 [{card}] {line}")

    res = ablate_bc7.run(range(19), dev, log=log, inputs=inputs)
    for m, stage in ((m, s) for s in bc7_stages.STAGES for m in bc7_stages.STAGE_MODES[s]):
        if (m, stage) not in res:  # mode 1's permute_invert: the tool leaves it out, as the TPU tool does
            log(f"mode {m}, {inputs[m].shape[0]} blocks, timed beside the tool:")
            res[(m, stage)] = ablate_bc7.time_stage(m, stage, inputs[m], log)
    torch.cuda.synchronize()
    launches, plain_calls = bc7_stages.launch_counts(), bc7_stages.plain_call_counts()
    require(all(launches[k] > 0 for k in launches), "a T1 kernel was not launched by the tool")
    require(sum(plain_calls.values()) == 0, f"plain version called in the tool's run: {plain_calls}")
    for (m, stage), r in res.items():
        p_out = torch.empty_like(r["out"])
        bc7_stages.stage_rows(m, stage, inputs[m], p_out)
        diff = int((r.pop("out").to(torch.int64) - p_out.to(torch.int64)).abs().max())
        require(diff == 0, f"T1 mode {m} {stage}: the timed launch differs from the plain version ({diff})")
        r["max_abs_err"] = diff
        r["plain_ms"] = median_ms(lambda m=m, stage=stage, p_out=p_out: bc7_stages.stage_rows(m, stage, inputs[m],
                                                                                              p_out), 3)
        r["launches"] = launches[(m, stage)]
    print(f"phase 19 [{card}]: the checksums of each of the {len(res)} timed launches == the plain version on the "
          f"same blocks (tolerance 0, max abs err 0); launches per kernel {sorted(set(launches.values()))}, "
          f"plain-version calls 0")
    print(f"phase 19 plain [{card}]: " + "; ".join(f"{m}/{s} {r['plain_ms']:.2f} ms" for (m, s), r in res.items())
          + " (plain stage versions on the card at the tool's inputs, as called, median of 3)")
    del inputs

    golden = torch.from_numpy(golden_in).to(dev)
    golden_out, golden_modes = torch.from_numpy(golden_bc7).to(dev), block_modes(golden)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    hbm = T1_BIG * T1_BLOCK_BYTES / HBM_BYTES_PER_S * 1e3
    bounds = {}  # stage -> [(mode, device ms, issue bound ms)]
    for m in range(19):
        small, small_out = golden[golden_modes == m], golden_out[golden_modes == m]
        reps = -(-T1_BIG // small.shape[0])
        blocks = small.repeat(reps, 1)[:T1_BIG]
        big = ablate_bc7.run([m], dev, log=lambda line: print(f"phase 19 {T1_BIG} a mode [{card}] {line}"),
                             inputs={m: blocks})
        for stage, r in ((s, big[(m, s)]) for s in bc7_stages.STAGES if (m, s) in big):
            p_small = torch.empty(small.shape[0], dtype=torch.int32, device=dev)
            bc7_stages.stage_rows(m, stage, small, p_small)  # rows are independent: tile the plain checksums
            require(bool(torch.equal(r.pop("out"), p_small.repeat(reps)[:T1_BIG])),
                    f"T1 mode {m} {stage} at {T1_BIG} blocks differs from the plain version")
        k1 = kernels.mode_kernel("bc7", m)
        k_out = torch.empty(T1_BIG, 16, dtype=torch.uint8, device=dev)
        k_err = torch.empty(T1_BIG, dtype=torch.bool, device=dev)
        k1(blocks, None, k_out, k_err)  # warm-up
        k1_big_ms = median_ms(lambda: k1(blocks, None, k_out, k_err), preload=True)
        require(bool(torch.equal(k_out, small_out.repeat(reps, 1)[:T1_BIG])) and not bool(k_err.any()),
                f"K1 mode {m} at {T1_BIG} blocks differs from the golden outputs")
        del blocks, k_out, k_err
        full_ms = big[(m, "full")]["ms"]
        split = ""
        if (m, "permute_invert") in big:
            pi_ms = big[(m, "permute_invert")]["ms"] - big[(m, "decode_fields")]["ms"]
            split = (f"; the permute/invert step alone (permute_invert - decode_fields) {pi_ms:.4f} ms, "
                     f"{100 * pi_ms / full_ms:.1f}% of full")
        print(f"phase 19 mode {m:2d} [{card}]: on the same {T1_BIG} blocks (checksums == plain, K1 == golden, "
              f"tolerance 0): K1 {k1_big_ms:.4f} ms = {T1_BIG / k1_big_ms / 1e3:.1f} Mblocks/s, T1 full "
              f"{full_ms:.4f} ms ({100 * full_ms / k1_big_ms:.0f}% of K1); stage time as a share of full: "
              + ", ".join(f"{s} {100 * big[(m, s)]['ms'] / full_ms:.0f}%" for s in bc7_stages.STAGES
                          if s != "full" and (m, s) in big)
              + split
              + f"; at the tool's input T1 full {res[(m, 'full')]['ms']:.4f} ms over {res[(m, 'full')]['blocks']} "
              f"blocks; K1 in phase 5 {k1_mode_ms[m]:.4f} ms over {k1_counts[m]} indexed blocks")
        parts = []
        for stage in (s for s in bc7_stages.STAGES if (m, s) in big):
            instr = sass[(f"bc7_stage/{stage}", m)]
            issue = T1_BIG / 32 * instr / (sms * ISSUE_SLOTS * clock * 1e6) * 1e3
            ms = big[(m, stage)]["ms"]
            bounds.setdefault(stage, []).append((m, ms, issue))
            parts.append(f"{stage} {ms:.4f} ms, {instr} SASS, issue bound {issue:.4f} ms, bound {max(hbm, issue):.4f} "
                         f"ms ({100 * max(hbm, issue) / ms:.1f}%)")
        print(f"phase 19 mode {m:2d} bounds [{card}]: HBM bound {hbm:.4f} ms ({T1_BLOCK_BYTES} B a block); "
              + "; ".join(parts))
    for stage, rows in bounds.items():
        total = sum(ms for _, ms, _ in rows)
        bound = sum(max(hbm, issue) for _, _, issue in rows)
        by_issue = [m for m, _, issue in rows if issue > hbm]
        print(f"phase 19 T1 {stage} [{card}]: {len(rows)} modes at {T1_BIG} blocks a mode, device time summed "
              f"{total:.4f} ms; bound summed {bound:.4f} ms ({100 * bound / total:.1f}%), the larger of the HBM bound "
              f"({hbm:.4f} ms a mode) and the issue bound ({sms} SMs x {ISSUE_SLOTS} x {clock:.0f} MHz); issue-bound "
              f"modes {by_issue}")
    torch.cuda.empty_cache()
    return res


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0])


def contiguous_modes(kernels, dev, card: str, golden_in, golden_out, block_bytes, shape, phase_ms, counts) -> None:
    """Phase 23: K1-K5 per mode on N_FULL contiguous blocks of that
    mode (its golden blocks tiled) with no index, each output checked
    against the tiled golden outputs; beside each time its HBM bound and
    its issue bound, N_FULL / 32 warps x the SASS count of phase 2 over the
    SMs' issue slots at the maximum SM clock."""
    from basisu_rs_tpu_torch.ops.dispatch import block_modes

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    golden = torch.from_numpy(golden_in).to(dev)
    modes = block_modes(golden)
    for t in TARGETS:
        gold_out = torch.from_numpy(np.ascontiguousarray(golden_out[t])).to(dev)
        k_out = torch.empty(N_FULL, gold_out.shape[1], dtype=torch.uint8, device=dev)
        k_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)
        total = 0.0
        for m in range(19):
            small, small_out = golden[modes == m], gold_out[modes == m]
            reps = -(-N_FULL // small.shape[0])
            blocks = small.repeat(reps, 1)[:N_FULL].contiguous()
            k = kernels.mode_kernel(t, m)
            k(blocks, None, k_out, k_err)  # warm-up
            ms = median_ms(lambda: k(blocks, None, k_out, k_err), preload=True)
            require(bool(torch.equal(k_out, small_out.repeat(reps, 1)[:N_FULL])) and not bool(k_err.any()),
                    f"{t} mode {m} at {N_FULL} contiguous blocks differs from the tiled golden outputs")
            total += ms
            regs, warps, instr = shape[(t, m)]
            hbm = N_FULL * block_bytes[t] / HBM_BYTES_PER_S * 1e3
            issue = N_FULL / 32 * instr / (sms * ISSUE_SLOTS * clock * 1e6) * 1e3
            print(f"phase 23 {t} mode {m:2d} [{card}]: {N_FULL} contiguous blocks == tiled golden (tolerance 0); "
                  f"device time {ms:.4f} ms = {N_FULL / ms / 1e3:.1f} Mblocks/s; HBM bound {hbm:.4f} ms "
                  f"({100 * hbm / ms:.1f}%); issue bound {issue:.4f} ms ({instr} SASS instructions a thread, "
                  f"{sms} SMs x {ISSUE_SLOTS} x {clock:.0f} MHz; {100 * issue / ms:.1f}%); {regs} registers, {warps} "
                  f"warps/SM; on the main path {phase_ms[t][m]:.4f} ms over {counts[m]} indexed blocks")
            del blocks
        print(f"phase 23 {t} [{card}]: sum over the 19 modes {total:.4f} ms at {N_FULL} blocks a mode")
        del k_out, k_err, gold_out
        torch.cuda.empty_cache()


def mip_slices(blocks: np.ndarray, textures: int, width: int, first: int = 0) -> list:
    """Mip chains of `textures` square textures of `width` texels, level 0
    down to 4x4 texels, cut in order from blocks[first:]: a list of
    (level, blocks a side, uint8 [n, 16] view) per slice."""
    out, ofs = [], first
    for _ in range(textures):
        w, lvl = width, 0
        while w >= 4:
            nb = w // 4
            out.append((lvl, nb, blocks[ofs: ofs + nb * nb]))
            ofs += nb * nb
            w, lvl = w // 2, lvl + 1
    return out


def corpus_phase(dev, card: str, full_np, full, kernels, etc1s) -> None:
    """Phase 20: the corpus transcoders at full size."""
    from basisu_rs_tpu_torch import transcode_uastc_blocks
    from basisu_rs_tpu_torch.models import (
        CorpusTranscoder,
        Etc1sCorpusTranscoder,
        Etc1sFileWork,
        Etc1sMultiCorpusTranscoder,
        UastcTranscoder,
    )
    from basisu_rs_tpu_torch.models.transcoder import MAX_BATCH_CODEBOOK_ENTRIES, to_host

    textures, width = CORPUS_SIZES[-1]
    slices = [s for _, _, s in mip_slices(full_np, textures, width)]
    total = sum(len(s) for s in slices)
    ends = np.cumsum([0] + [len(s) for s in slices]).tolist()
    for t in ("bc7", "rgba"):
        ref = to_host(transcode_uastc_blocks(full[:total], t)[0])
        kernels.reset_counts()
        outs = CorpusTranscoder(t).transcode_slices(slices)
        n_launch = sum(kernels.launch_counts()[t]) + kernels.tile_launch_counts().get(t, 0)
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(n_launch <= (1 if t in kernels.TILED else 19) and plain_calls == 0,
                f"corpus {t}: {n_launch} launches, {plain_calls} plain calls")
        require(all(np.array_equal(o, ref[a:b]) for o, a, b in zip(outs, ends, ends[1:])),
                f"corpus {t}: a slice differs from transcode_uastc_blocks")
        tr = UastcTranscoder(t)
        kernels.reset_counts()
        out, err = tr.transcode_async(full_np[:total]).gather()
        n_async = sum(kernels.launch_counts()[t]) + kernels.tile_launch_counts().get(t, 0)
        require(n_async <= (1 if t in kernels.TILED else 19) and np.array_equal(out, ref) and not err.any(),
                f"transcode_async {t} differs")
        print(f"phase 20 corpus {t} [{card}]: {len(slices)} mip slices of {textures} {width}x{width} textures, {total} blocks, "
              f"CorpusTranscoder and transcode_async + gather bit-exact vs transcode_uastc_blocks; launches "
              f"{n_launch} and {n_async} a call; plain-version calls 0")
        del ref, outs, out

    for textures, width in CORPUS_SIZES:
        sl = [s for _, _, s in mip_slices(full_np, textures, width)]
        n = sum(len(s) for s in sl)
        ct = CorpusTranscoder("bc7")
        ct.transcode_slices(sl)  # warm-up
        ct.inner.profiler.stats.clear()
        ms = host_ms(lambda: ct.transcode_slices(sl))
        st = ct.profiler.stats
        split = ", ".join(f"{k} {1e3 * v.seconds / v.calls:.2f}" for k, v in sorted(st.items()))
        tr = UastcTranscoder("bc7")
        dev_ms = host_ms(lambda: tr.transcode_async(full[:n]))
        print(f"phase 20 corpus scaling bc7 [{card}]: {textures} textures of {width}x{width}, {n} blocks: "
              f"transcode_slices {ms:.2f} ms = {mtex(n, ms):.1f} Mtexels/s (host clock + sync, median of "
              f"{FILE_REPS}; profiler stages, ms a call: {split}); device-resident transcode_async {dev_ms:.2f} ms "
              f"= {mtex(n, dev_ms):.1f} Mtexels/s")

    rng = np.random.default_rng(SEED + 3)
    per_slice = N_FULL // (ETC1S_FILES * ETC1S_FILE_SLICES)
    files = []
    for _ in range(ETC1S_FILES):
        ep, sel = etc1s_codebooks(rng, ETC1S_BOOK, ETC1S_BOOK)
        files.append(Etc1sFileWork(ep, sel, [(rng.integers(0, ETC1S_BOOK, per_slice).astype(np.int32),
                                              rng.integers(0, ETC1S_BOOK, per_slice).astype(np.int32))
                                             for _ in range(ETC1S_FILE_SLICES)]))
    for t in ("rgba", "etc1"):
        multi = Etc1sMultiCorpusTranscoder(t)
        multi.transcode_files(files[:1])  # warm-up
        torch.cuda.synchronize()
        etc1s.reset_counts()
        got = multi.transcode_files(files)
        launches, plain_calls = etc1s.launch_counts(), etc1s.plain_call_counts()
        kind = "rgba" if t == "rgba" else "etc1"
        groups = -(-ETC1S_FILES * ETC1S_BOOK // MAX_BATCH_CODEBOOK_ENTRIES)  # what the cap implies
        require(launches == {k: groups * (k == kind) for k in etc1s.KINDS} and sum(plain_calls.values()) == 0,
                f"ETC1S corpus {t}: launches {launches}, plain calls {plain_calls}")
        per_file = [Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, t).transcode_slices(fw.slices) for fw in files]
        require(all(np.array_equal(g, w) for gs, ws in zip(got, per_file) for g, w in zip(gs, ws)),
                f"ETC1S corpus {t}: multi-file output differs from per-file runs")
        multi_ms = host_ms(lambda: multi.transcode_files(files))
        per_ms = host_ms(lambda: [Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, t).transcode_slices(fw.slices)
                                  for fw in files])
        line = (f"phase 20 etc1s corpus {t} [{card}]: {ETC1S_FILES} files of {ETC1S_BOOK}-entry codebooks, {N_FULL} "
                f"blocks, bit-exact vs per-file Etc1sCorpusTranscoder; launches {launches[kind]} (cap "
                f"{MAX_BATCH_CODEBOOK_ENTRIES} entries); plain-version calls 0; multi-file {multi_ms:.2f} ms = {mtex(N_FULL, multi_ms):.1f} "
                f"Mtexels/s, {ETC1S_FILES} per-file calls {per_ms:.2f} ms (host clock + sync, median of {FILE_REPS})")
        if t == "rgba":
            res = multi.transcode_files(files, resident=True)
            require(all(d.device == dev and np.array_equal(to_host(d), g)
                        for ds, gs in zip(res, got) for d, g in zip(ds, gs)), "resident ETC1S corpus differs")
            res_ms = host_ms(lambda: multi.transcode_files(files, resident=True))
            line += f"; resident=True bit-exact, {res_ms:.2f} ms = {mtex(N_FULL, res_ms):.1f} Mtexels/s"
            del res
        print(line)
        del got, per_file
    torch.cuda.empty_cache()


def pipeline_phase(dev, card: str, full_np, endpoints, selectors, read_to_rgba, basis) -> None:
    """Phase 21: the corpus pipeline over files on disk."""
    import tempfile

    from basisu_rs_tpu_torch.models import BasisCorpusPipeline, PipelineState

    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        t0 = time.perf_counter()
        paths, bad = pipeline_corpus(Path(tmp), full_np, endpoints, selectors)
        nbytes = sum(p.stat().st_size for p in paths)
        print(f"phase 21 corpus: {PIPE_UASTC} UASTC files ({PIPE_WIDTH}x{PIPE_WIDTH}, mips to 4x4), {PIPE_ETC1S} "
              f"ETC1S files ({PIPE_ETC1S // 2} with alpha slices), 1 corrupt file, {nbytes} bytes, written in "
              f"{time.perf_counter() - t0:.2f} s (host)")

        def pipeline(workers):
            pipe = BasisCorpusPipeline("rgba", workers=workers)
            res = {r.path: r.images for r in pipe.run(paths)}
            torch.cuda.synchronize()
            return res, [(p, str(e)) for p, e in pipe.errors]

        def inline():
            res, errors = {}, []
            for p in paths:
                try:
                    res[str(p)] = read_to_rgba(p.read_bytes())[1]
                except basis.BasisError as e:
                    errors.append((str(p), str(e)))
            torch.cuda.synchronize()
            return res, errors

        runs = {"workers=1": lambda: pipeline(1), "workers=4": lambda: pipeline(4), "inline": inline}
        ref = None
        for name, fn in runs.items():
            res, errors = fn()
            require(errors == [(str(bad), "Data CRC16 failed")], f"pipeline {name}: errors {errors}")
            require(len(res) == len(paths) - 1, f"pipeline {name}: {len(res)} files")
            if ref is None:
                ref = res
            else:
                for p, imgs in res.items():
                    require(len(imgs) == len(ref[p]) and all(
                        (a.w, a.h, a.stride) == (b.w, b.h, b.stride) and torch.equal(a.data, b.data)
                        for a, b in zip(imgs, ref[p])), f"pipeline {name}: {p} differs")
        texels = sum(int(i.w) * int(i.h) for imgs in ref.values() for i in imgs)
        del ref, res
        times = {name: host_ms(fn) for name, fn in runs.items()}
        state = PipelineState()
        first = [r.path for r in BasisCorpusPipeline("rgba").run(paths[:40], state)]
        pipe = BasisCorpusPipeline("rgba")
        rest = [r.path for r in pipe.run(paths, state)]
        require(first == [str(p) for p in paths[:40]] and rest == [str(p) for p in paths[41:]]
                and [p for p, _ in pipe.errors] == [str(bad)], "pipeline resume")
        print(f"phase 21 pipeline [{card}]: {len(paths) - 1} files, images bit-exact across workers=1, workers=4 and "
              f"inline read_to_rgba; the corrupt file in errors as 'Data CRC16 failed'; resume after 40 files "
              f"yields the other {len(rest)} and skips the 40")
        print(f"phase 21 pipeline time [{card}] (host clock + sync, median of {FILE_REPS}, {texels} texels): "
              + ", ".join(f"{k} {v:.1f} ms = {texels / v / 1e3:.1f} Mtexels/s" for k, v in times.items()))
        torch.cuda.empty_cache()


def cli_phase(card: str, full_np, endpoints, selectors) -> None:
    """Phase 22: the CLI on the card."""
    import contextlib
    import io
    import tempfile

    from basisu_rs_tpu_torch import read_to_bc7, read_to_etc2, read_to_rgba
    from basisu_rs_tpu_torch.__main__ import main as cli_main
    from basisu_rs_tpu_torch.container import basis, ktx, ktx2, png
    from basisu_rs_tpu_torch.container.writer import write_uastc_basis

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "basisu_rs_tpu_torch", "selftest"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    selftest_s = time.perf_counter() - t0
    expect = [f"{t}: OK ({len(np.load(FIXTURE)['bc7_in'])} blocks)" for t in ("rgba", "astc", "bc7", "etc1", "etc2")]
    require(res.returncode == 0 and res.stdout.splitlines() == expect,
            f"selftest rc {res.returncode}: {res.stdout} {res.stderr[-2000:]}")
    print(f"phase 22 selftest [{card}]: `python -m basisu_rs_tpu_torch selftest` exit 0, all five targets OK, "
          f"{selftest_s:.2f} s as a subprocess")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        chain = mip_slices(full_np, 1, PIPE_WIDTH)
        buf = write_uastc_basis([dict(blocks=s, nbx=nb, nby=nb, orig_width=4 * nb, orig_height=4 * nb,
                                      image_index=0, level_index=lvl) for lvl, nb, s in chain])
        src = Path(tmp) / "tex.basis"
        src.write_bytes(buf)
        with contextlib.redirect_stdout(io.StringIO()) as so:
            require(cli_main(["info", str(src)]) == 0, "info failed")
        info = json.loads(so.getvalue())
        require(info["format"] == "UASTC4x4" and info["data_crc_ok"] and len(info["slices"]) == len(chain),
                f"info: {info}")
        descs = basis.read_slice_descs(buf, basis.read_header(buf))
        cases = (("ktx2", "bc7", read_to_bc7, ktx2.write_ktx2), ("ktx", "etc2", read_to_etc2, ktx.write_ktx))
        for container, target, reader, writer in cases:
            out = Path(tmp) / container
            with contextlib.redirect_stdout(io.StringIO()):
                require(cli_main(["transcode", str(src), "--target", target, "--container", container, "-o",
                                  str(out)]) == 0, f"transcode {container}")
            (chain_imgs,) = ktx.group_mip_chains(reader(buf), descs)
            require((out / f"tex_0.{target}.{container}").read_bytes() == writer(chain_imgs, target),
                    f"transcode --container {container} differs from the writer")
        out = Path(tmp) / "png"
        with contextlib.redirect_stdout(io.StringIO()):
            require(cli_main(["transcode", str(src), "--target", "rgba", "--container", "png", "-o", str(out)]) == 0,
                    "transcode png")
        images = read_to_rgba(buf)[1]
        require(all((out / f"tex_{i}.png").read_bytes() == png.write_png(img) for i, img in enumerate(images)),
                "transcode --container png differs from write_png")
    print(f"phase 22 cli [{card}]: info JSON of a {len(chain)}-level file; transcode --container ktx2 (bc7), ktx "
          f"(etc2) and png (rgba, {len(images)} files) byte-equal to the writers applied to the readers' output")


def sharded_phase(dev, card: str, full_np, full, uastc_buf, etc1s_files, endpoints, selectors, idx_np, bad) -> None:
    """Phase 24: the sharded path (basisu_rs_tpu_torch.parallel) on the
    card, every output held bit-exact against the single-device path."""
    import contextlib
    import io
    import tempfile

    from basisu_rs_tpu_torch import BasisError, read_to_bc7, read_to_etc1, read_to_rgba, transcode_uastc_blocks
    from basisu_rs_tpu_torch.__main__ import main as cli_main
    from basisu_rs_tpu_torch.container.writer import write_uastc_basis
    from basisu_rs_tpu_torch.ops import etc1s, kernels
    from basisu_rs_tpu_torch.ops.dispatch import shard_groups, transcode_blocks, transcode_shard
    from basisu_rs_tpu_torch.parallel import make_mesh, sharded_etc1s_transcode, sharded_transcode
    from basisu_rs_tpu_torch.base import shard_bounds as bounds

    mesh1 = make_mesh(1)
    require(mesh1 == (dev,), f"make_mesh(1) gave {mesh1}")
    four = [dev] * 4
    meshes = {"make_mesh(1)": mesh1}
    n_cards = torch.cuda.device_count()
    for n in sorted({2, n_cards}):
        if 2 <= n <= n_cards:
            meshes[f"make_mesh({n})"] = make_mesh(n)

    def shard_launches_ms(blocks, t, n_shards):
        """Device time of the sharded call's launches alone (each shard's
        partition, where the target has one, taken beforehand), as the call
        sends them."""
        shards = [blocks[a:b] for a, b in bounds(blocks.shape[0], n_shards)]
        groups = shard_groups(shards, t)
        out = torch.empty(blocks.shape[0], kernels.OUT_BYTES[t], dtype=torch.uint8, device=dev)
        err = torch.empty(blocks.shape[0], dtype=torch.bool, device=dev)

        def run():
            for (a, b), s, group in zip(bounds(blocks.shape[0], n_shards), shards, groups):
                transcode_shard(s, t, group, out[a:b], err[a:b])

        return median_ms(run, preload=True)

    def check_uastc(label, blocks, t, mesh, launches_each):
        ref_out, ref_err = transcode_blocks(blocks, t)
        sharded_transcode(blocks, t, mesh)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_counts()
        out, err = sharded_transcode(blocks, t, mesh)
        torch.cuda.synchronize()
        launches = launch_text(kernels, t, check_launches(kernels, t, launches_each, label))
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(plain_calls == 0, f"{label} {t}: plain version called on the sharded path: {plain_calls}")
        require(out.dtype == ref_out.dtype and out.shape == ref_out.shape and out.device == dev,
                f"{label} {t}: output {out.dtype} {tuple(out.shape)} {out.device}")
        require(bool(torch.equal(out, ref_out)) and bool(torch.equal(err, ref_err)),
                f"{label} {t}: sharded output or err differs from the single-device path")
        return out, err, launches

    def timed_pair(single, sharded):
        """Median ms of 10 warm whole calls each, in the order single,
        sharded, sharded, single."""
        s1, m1, m2, s2 = (statistics.median(times_ms(f)) for f in (single, sharded, sharded, single))
        return (s1, s2), (m1, m2)

    # ---- (a), (f): UASTC on make_mesh(1) (and make_mesh(2)) at 2^23 blocks
    for name, mesh in meshes.items():
        for t in TARGETS:
            _, _, launches = check_uastc(name, full, t, mesh, len(mesh))
            (s1, s2), (m1, m2) = timed_pair(lambda: transcode_uastc_blocks(full, t),
                                            lambda: sharded_transcode(full, t, mesh))
            dev_ms = shard_launches_ms(full, t, len(mesh)) if len(mesh) == 1 else None
            dev_line = f"; launches' device time {dev_ms:.4f} ms" if dev_ms is not None else ""
            print(f"phase 24 {t} sharded_transcode on {name} [{card}]: {N_FULL} blocks bit-exact vs transcode_blocks "
                  f"(tolerance 0, max abs err 0); launches {launches}; plain-version calls 0; whole call (CUDA events, "
                  f"warm, median of {REPS}, single, mesh, mesh, single) single-device {s1:.4f} / {s2:.4f} ms, "
                  f"{name} {m1:.4f} / {m2:.4f} ms = {100 * (m1 + m2) / (s1 + s2):.1f}% of the single-device call"
                  + dev_line)

    # ---- (b): four shards on the one card, ragged, with invalid blocks -----
    n_b = N_FULL + 3
    per = -(-n_b // 4)
    i_mode, i_pat = 2 * per + per // 3, 3 * per + per // 5  # inside the third and the fourth shard
    blocks_np = np.concatenate([full_np, full_np[:3]])
    blocks_np[i_mode], blocks_np[i_pat] = bad[0], bad[1]
    blocks_b = torch.from_numpy(blocks_np).to(dev)
    for t in TARGETS:
        _, err, launches = check_uastc("[cuda:0] x 4", blocks_b, t, four, 4)
        bad_rows = torch.nonzero(err).flatten().tolist()
        require(bad_rows == [i_mode, i_pat], f"[cuda:0] x 4 {t}: err at {bad_rows}, expected {[i_mode, i_pat]}")
    (s1, s2), (m1, m2) = timed_pair(lambda: transcode_uastc_blocks(blocks_b, "bc7"),
                                    lambda: sharded_transcode(blocks_b, "bc7", four))
    print(f"phase 24 [cuda:0] x 4 [{card}]: {n_b} blocks in shards of {per} and {n_b - 3 * per}, invalid mode at "
          f"{i_mode} (third shard), invalid pattern at {i_pat} (fourth); out and err == the single-device path for "
          f"{', '.join(TARGETS)} (tolerance 0), err exactly at those rows, 4 launches a mode (bc7: 4 tile-kernel "
          f"launches), 0 plain calls; bc7 whole call single-device {s1:.4f} / {s2:.4f} ms, four shards {m1:.4f} / "
          f"{m2:.4f} ms; the 4 launches' device time {shard_launches_ms(blocks_b, 'bc7', 4):.4f} ms against "
          f"{shard_launches_ms(blocks_b, 'bc7', 1):.4f} ms for the one of one shard")
    del blocks_b
    slice_blocks = SLICE_BLOCKS_X * SLICE_BLOCKS_X
    for order, msg in (((i_mode, bad[0]), (i_pat, bad[1])), "invalid mode index"), \
                      (((i_mode, bad[1]), (i_pat, bad[0])), "block pattern is not valid"):
        file_np = np.concatenate([full_np, full_np[:3]])
        for row, block in order:
            file_np[row] = block
        bad_buf = write_uastc_basis(
            [dict(blocks=file_np[k * slice_blocks:(k + 1) * slice_blocks], nbx=SLICE_BLOCKS_X, nby=SLICE_BLOCKS_X,
                  orig_width=4 * SLICE_BLOCKS_X, orig_height=4 * SLICE_BLOCKS_X) for k in range(SLICES)]
            + [dict(blocks=file_np[N_FULL:], nbx=3, nby=1, orig_width=12, orig_height=4)])
        for mesh in (None, mesh1, four):
            try:
                read_to_bc7(bad_buf, mesh=mesh)
            except BasisError as e:
                require(str(e) == msg, f"read_to_bc7(mesh={mesh}): message {e!r}, expected {msg!r}")
            else:
                raise RuntimeError(f"read_to_bc7(mesh={mesh}) accepted a file with invalid blocks")
        print(f"phase 24 errors [{card}]: a {SLICES + 1}-slice file of {n_b} blocks, rows {i_mode} and {i_pat} "
              f"invalid, raises {msg!r} through read_to_bc7 with no mesh, make_mesh(1) and [cuda:0] x 4")
    del file_np, bad_buf

    # ---- (c), (f): ETC1S on every mesh --------------------------------------
    idx = [torch.from_numpy(a).to(dev) for a in idx_np]
    single = {
        "rgba": lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1]),
        "rgba_alpha": lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], (idx[2], idx[3])),
        # K7 has no entry of its own: its wrapper, after packing the codebooks as the entries do
        "alpha": lambda: etc1s.etc1s_kernel("alpha")(*etc1s_tables(etc1s, endpoints, selectors, "alpha", dev),
                                                     idx[0], idx[1]).view(torch.uint32),
        "etc1": lambda: etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1]),
    }
    for name, mesh in {**meshes, "[cuda:0] x 4": four}.items():
        for kind in etc1s.KINDS:
            extra = (idx[2], idx[3]) if kind == "rgba_alpha" else ()

            def sharded(kind=kind, mesh=mesh, extra=extra):
                return sharded_etc1s_transcode(kind, endpoints, selectors, idx[0], idx[1], mesh, extra_idx=extra)

            ref = single[kind]()
            sharded()  # warm-up
            torch.cuda.synchronize()
            etc1s.reset_counts()
            got = sharded()
            torch.cuda.synchronize()
            launches, plain_calls = etc1s.launch_counts(), etc1s.plain_call_counts()
            n_mesh = len(mesh)
            require(launches == {k: n_mesh * (k == kind) for k in etc1s.KINDS}, f"{name} {kind}: launches {launches}")
            require(sum(plain_calls.values()) == 0, f"{name} {kind}: plain version called: {plain_calls}")
            require(got.dtype == ref.dtype and got.shape == ref.shape and got.device == dev and bool(torch.equal(got, ref)),
                    f"{name} {kind}: sharded_etc1s_transcode differs from the single-device entry")
            del got, ref
            (s1, s2), (m1, m2) = timed_pair(single[kind], sharded)
            print(f"phase 24 etc1s {kind} on {name} [{card}]: {N_FULL} blocks bit-exact vs the single-device entry "
                  f"(tolerance 0); launches {launches[kind]}; plain calls 0; whole call (median of {REPS}) single-device "
                  f"{s1:.4f} / {s2:.4f} ms, {name} {m1:.4f} / {m2:.4f} ms")
    del idx
    torch.cuda.empty_cache()

    # ---- (d): the file readers with mesh= -----------------------------------
    reads = [("uastc 8x4096²", uastc_buf, "bc7", lambda b, **k: read_to_bc7(b, **k)),
             ("uastc 8x4096²", uastc_buf, "rgba", lambda b, **k: read_to_rgba(b, **k)[1]),
             ("uastc 8x4096²", uastc_buf, "etc1", lambda b, **k: read_to_etc1(b, **k))]
    reads += [(f"etc1s {name}", buf, reader, fn) for name, buf in etc1s_files.items()
              for reader, fn in (("rgba", lambda b, **k: read_to_rgba(b, **k)[1]),
                                 ("etc1", lambda b, **k: read_to_etc1(b, **k)))]
    for label, buf, reader, fn in reads:
        ref = fn(buf)
        for name, mesh in (("make_mesh(1)", mesh1), ("[cuda:0] x 4", four)):
            kernels.reset_counts()
            etc1s.reset_counts()
            images = fn(buf, mesh=mesh)
            torch.cuda.synchronize()
            if label.startswith("uastc"):
                check_launches(kernels, reader, len(mesh), f"{label} read_to_{reader} on {name}")
            else:
                kind = "rgba_alpha" if reader == "rgba" and label == "etc1s alpha" else reader
                launched = etc1s.launch_counts()
                require(launched == {k: len(mesh) * (k == kind) for k in etc1s.KINDS},
                        f"{label} read_to_{reader} on {name}: launches {launched}")
            plain_calls = (sum(sum(c) for c in kernels.plain_call_counts().values())
                           + sum(etc1s.plain_call_counts().values()))
            require(plain_calls == 0, f"{label} read_to_{reader} on {name}: {plain_calls} plain calls")
            require(len(images) == len(ref), f"{label} read_to_{reader} on {name}: {len(images)} images")
            for img, r in zip(images, ref):
                require((img.w, img.h, img.stride) == (r.w, r.h, r.stride) and img.data.device == dev
                        and bool(torch.equal(img.data, r.data)),
                        f"{label} read_to_{reader} on {name}: an image differs from the read without a mesh")
            del images
        del ref
        print(f"phase 24 read [{card}]: {label} read_to_{reader} with mesh=make_mesh(1) and mesh=[cuda:0] x 4, "
              f"images bit-exact vs the read without a mesh; one launch a present mode or kind a shard, 0 plain calls")
    split = {name: host_ms(lambda mesh=mesh: read_to_bc7(uastc_buf, mesh=mesh))
             for name, mesh in (("no mesh", None), ("make_mesh(1)", mesh1), ("[cuda:0] x 4", four))}
    print(f"phase 24 read time [{card}] (host clock + sync, median of {FILE_REPS}): read_to_bc7 of the 128 MiB file "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()))
    torch.cuda.empty_cache()

    # ---- (e): the CLI's --mesh ----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        chain = mip_slices(full_np, 1, PIPE_WIDTH)
        src = Path(tmp) / "tex.basis"
        src.write_bytes(write_uastc_basis([dict(blocks=b, nbx=nb, nby=nb, orig_width=4 * nb, orig_height=4 * nb,
                                                image_index=0, level_index=lvl) for lvl, nb, b in chain]))
        outs = {}
        for mesh_args in ((), ("--mesh", "1")):
            out = Path(tmp) / f"out{len(mesh_args)}"
            with contextlib.redirect_stdout(io.StringIO()):
                require(cli_main(["transcode", str(src), "--target", "bc7", *mesh_args, "-o", str(out)]) == 0,
                        f"transcode {' '.join(mesh_args)}")
            outs[mesh_args] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        require(outs[()] and outs[()] == outs[("--mesh", "1")], "transcode --mesh 1 differs from the unsharded run")
        too_many = n_cards + 1
        err_text = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err_text):
            rc = cli_main(["transcode", str(src), "--mesh", str(too_many), "-o", str(Path(tmp) / "refused")])
        expect = (f"--mesh {too_many}: requested a {too_many}-device mesh but CUDA has {n_cards} device(s); for a "
                  "sharding dry run on CPU devices pass allow_cpu_fallback=True\n")
        require(rc == 2 and err_text.getvalue() == expect, f"--mesh {too_many}: rc {rc}, stderr {err_text.getvalue()!r}")
    print(f"phase 24 cli [{card}]: transcode --mesh 1 writes the {len(outs[()])} files of the unsharded run byte for "
          f"byte; --mesh {too_many} exits with rc 2 and the mesh's message ({n_cards} card(s))")
    if n_cards < 2:
        print(f"phase 24 [{card}]: {n_cards} card on this machine: the split across cards (make_mesh(n), n > 1) was "
              f"proved on the CPU only (tests/test_torch_parallel.py)")


def bench_phase(card: str) -> None:
    """Phase 25: the port's benchmark as a user runs it, in a subprocess at
    its default size with BENCH_FAST unset, checked for a whole line."""
    from basisu_rs_tpu_torch.bench import LINE_KEYS

    env = {k: v for k, v in os.environ.items() if k != "BENCH_FAST"}
    res = subprocess.run([sys.executable, "-m", "basisu_rs_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    for line in res.stderr.splitlines():
        print(f"phase 25 bench stderr: {line}")
    require(res.returncode == 0, f"python -m basisu_rs_tpu_torch.bench exited with {res.returncode}")
    lines = res.stdout.strip().splitlines()
    require(bool(lines), "the bench printed no line")
    line = json.loads(lines[-1])
    missing = sorted((set(LINE_KEYS) | {"device"}) - set(line))
    require(not missing, f"the bench's line lacks {missing}")
    rates = {k: v for k, v in line.items() if k not in ("metric", "unit", "device", "etc1s_host_degenerate")}
    bad = {k: v for k, v in rates.items() if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
    require(not bad, f"the bench's line has rates that are not finite and above 0: {bad}")
    name = card.rsplit(",", 1)[0].strip()
    require(line["device"].get("name") == name, f"the bench's device {line['device']} is not the card {name!r}")
    print(f"phase 25 bench [{card}]: exit 0, {len(line)} keys (bench.py's but vs_baseline, and device), every rate "
          f"finite and above 0; the line follows")
    print("phase 25 bench line " + json.dumps(line))


def tile_phase(dev, card: str, golden_in, golden_out) -> None:
    """Phase 26: K1 in one launch (`kernels.tile_kernel("bc7")`, the kernel
    uastc_kernel_tiles<Bc7>) against the per-mode path (the partition and 19
    launches), byte for byte with the err flags, on N_FULL blocks of four
    mixes, and on the first mix also against the plain version (the
    partition and each mode's `bc7.transcode_rows`); then its device time
    beside the HBM bound and the per-mode kernels' time over contiguous
    blocks, its registers, resident warps and lane share."""
    from basisu_rs_tpu_torch.ops import build, kernels
    from basisu_rs_tpu_torch.ops.dispatch import block_modes, dispatch, partition, transcode_blocks
    from basisu_rs_tpu_torch.tables import INVALID_MODE
    from basisu_rs_tpu_torch.utils import profiling

    rng = np.random.default_rng(SEED + 26)
    golden = torch.from_numpy(golden_in).to(dev)
    modes = block_modes(golden)
    shuffled = golden_in[rng.integers(0, len(golden_in), N_FULL)]  # the resident cell's mix
    by_mode = [golden_in[modes.cpu().numpy() == m] for m in range(19)]
    run_modes = rng.integers(0, 19, N_FULL // 64)
    run_lengths = rng.integers(1, 2048, len(run_modes))  # runs of one mode, 1-2047 blocks
    runs = np.concatenate([by_mode[m][rng.integers(0, len(by_mode[m]), k)] for m, k in zip(run_modes, run_lengths)])
    require(len(runs) >= N_FULL, "runs mix too short")
    bad = invalid_blocks()
    faulty = shuffled.copy()
    faulty[::97], faulty[5::89] = bad[0], bad[1]
    faulty[-N_RANDOM:] = rng.integers(0, 256, (N_RANDOM, 16), dtype=np.uint8)  # every mode, random patterns
    mixes = {"shuffled": shuffled, "runs": runs[:N_FULL], f"shuffled, {N_FULL - 7} blocks": shuffled[: N_FULL - 7],
             "invalid mode / pattern": faulty}
    tile = kernels.tile_kernel("bc7")
    for name, x_np in mixes.items():
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        n = x.shape[0]
        out, err = tile(x)  # warm-up, and the shared memory attribute
        ((order, counts),) = partition([x])
        ref_out, ref_err = dispatch(x, "bc7", order, counts)
        kernels.reset_counts()
        out, err = tile(x)
        require(kernels.tile_launch_counts()["bc7"] == 1 and sum(kernels.launch_counts()["bc7"]) == 0,
                f"tile {name}: launches {kernels.tile_launch_counts()}, per mode {kernels.launch_counts()['bc7']}")
        require(bool(torch.equal(out, ref_out)) and bool(torch.equal(err, ref_err)),
                f"tile {name}: one launch differs from the 19-launch path "
                f"({int((out != ref_out).any(1).sum())} rows, {int((err != ref_err).sum())} err flags)")
        if name == "shuffled":
            require(not bool(err.any()) and counts[INVALID_MODE] == 0, "tile: the golden mix flagged err")
            p_out, p_err = torch.empty_like(out), torch.empty_like(err)
            s = 0
            for m, c in enumerate(counts[:INVALID_MODE]):
                if c:
                    kernels.PLAIN["bc7"](m, x, order[s : s + c], p_out, p_err)
                s += c
            require(bool(torch.equal(out, p_out)) and bool(torch.equal(err, p_err)),
                    f"tile {name}: one launch differs from the plain version "
                    f"({int((out != p_out).any(1).sum())} rows, {int((err != p_err).sum())} err flags)")
            del p_out, p_err
        profiling.clear()
        profiling.enable()
        try:
            tile(x)
            rounds = profiling.records().total("tile_warp_rounds")
        finally:
            profiling.disable()
            profiling.clear()
        lanes = 100 * n / (32 * rounds)
        ms = median_ms(lambda: tile(x), preload=True)
        idx = [order[a:b] for a, b in zip(np.cumsum([0] + counts[:-1]).tolist(), np.cumsum(counts).tolist())]

        def per_mode():
            for m in range(19):
                if counts[m]:
                    kernels.mode_kernel("bc7", m)(x, idx[m], ref_out, ref_err, check_index=False)

        per_mode_ms = median_ms(per_mode, preload=True)
        call_ms = median_ms(lambda: transcode_blocks(x, "bc7"))
        bound = n * 33 / HBM_BYTES_PER_S * 1e3
        plain_too = " and the plain version" if name == "shuffled" else ""
        print(f"phase 26 tile {name} [{card}]: {n} blocks ({int(err.sum())} with err), one launch == the 19-launch "
              f"path{plain_too} (out and err, tolerance 0); device time {ms:.4f} ms = {mtex(n, ms):.1f} Mtexels/s, "
              f"HBM bound "
              f"{bound:.4f} ms (33 B a block, {100 * bound / ms:.1f}%); the per-mode path's launches "
              f"{per_mode_ms:.4f} ms; transcode_blocks as called {call_ms:.4f} ms; warp-rounds {rounds}, lane share "
              f"{lanes:.2f}%")
        del x, out, err, ref_out, ref_err, order, idx
        torch.cuda.empty_cache()

    # the per-mode kernels over contiguous blocks of one mode, as phase 23 times them
    k_out = torch.empty(N_FULL, 16, dtype=torch.uint8, device=dev)
    k_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)
    contiguous = 0.0
    for m in range(19):
        small = golden[modes == m]
        blocks = small.repeat(-(-N_FULL // small.shape[0]), 1)[:N_FULL].contiguous()
        k = kernels.mode_kernel("bc7", m)
        k(blocks, None, k_out, k_err)
        contiguous += median_ms(lambda: k(blocks, None, k_out, k_err), preload=True)
        del blocks
    tiled = torch.from_numpy(tiled_blocks(golden_in)).to(dev)
    out, err = tile(tiled)
    expected = np.tile(golden_out, (-(-N_FULL // len(golden_in)), 1))[:N_FULL]
    require(bool(torch.equal(out, torch.from_numpy(expected).to(dev))) and not bool(err.any()),
            "tile: phase 5's tiled golden mix differs from the golden outputs")
    tiled_ms = median_ms(lambda: tile(tiled), preload=True)
    r = build.ptxas_report().get(("bc7", "tiles"), {})
    require(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0, f"tile kernel spills or no report: {r}")
    sass = build.sass_counts().get(("bc7", "tiles"))
    print(f"phase 26 tile [{card}]: phase 5's tiled golden mix {tiled_ms:.4f} ms (== golden); the per-mode kernels "
          f"over {N_FULL} contiguous blocks of one mode average {contiguous / 19:.4f} ms (sum {contiguous:.4f} ms over "
          f"19 modes); HBM bound {N_FULL * 33 / HBM_BYTES_PER_S * 1e3:.4f} ms; uastc_kernel_tiles<Bc7>: "
          f"{r['registers']} registers, {r['stack']} B stack, 0 B spills, "
          f"{kernels.tile_resident_warps('bc7')} resident warps per SM, {sass} SASS instructions")


def sharded_phase_alone(dev, card: str) -> int:
    """`--phase 24`: the build and phase 24 on the inputs main() gives it."""
    from basisu_rs_tpu_torch.container.writer import write_uastc_basis
    from basisu_rs_tpu_torch.ops import build

    so, seconds = build.build()
    print(f"phase 2 build: {so.name} in {seconds:.2f} s")
    full_np = tiled_blocks(np.load(FIXTURE)["bc7_in"])
    full = torch.from_numpy(full_np).to(dev)
    buf = write_uastc_basis(uastc_texture_slices(full_np))
    endpoints, selectors, idx_np = etc1s_streams()
    etc1s_files = {name: b for name, (b, _, _) in etc1s_texture_files(endpoints, selectors, idx_np).items()}
    t0 = time.perf_counter()
    sharded_phase(dev, card, full_np, full, buf, etc1s_files, endpoints, selectors, idx_np, invalid_blocks())
    print(f"phase 24 took {time.perf_counter() - t0:.2f} s")
    print(card)
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one CUDA card (module docstring).")
    ap.add_argument("--phase", type=int, choices=(24, 25, 26),
                    help="run only this phase (and the card facts and build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card")

    from basisu_rs_tpu_torch import (
        BasisError,
        read_to_astc,
        read_to_bc7,
        read_to_etc1,
        read_to_etc2,
        read_to_rgba,
        transcode_uastc_block_to_astc,
        transcode_uastc_block_to_etc1,
        transcode_uastc_block_to_etc2,
        transcode_uastc_blocks,
        unpack_uastc_block_to_rgba,
    )
    from basisu_rs_tpu_torch.container import basis
    from basisu_rs_tpu_torch.container.writer import write_uastc_basis
    from basisu_rs_tpu_torch.ops import bc7_stages, build, etc1s, kernels
    from basisu_rs_tpu_torch.ops.dispatch import block_modes, partition, transcode_blocks
    from basisu_rs_tpu_torch.tables import INVALID_MODE, np_tables

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plain = kernels.PLAIN
    out_bytes = kernels.OUT_BYTES
    # HBM bytes the function needs a block: 16 in, the output, a 1-byte err.
    # The dispatch's int64 index list adds INDEX_BYTES more; that is a cost
    # of partitioning by mode, not of the function, so the bound leaves it out.
    block_bytes = {t: 16 + out_bytes[t] + 1 for t in TARGETS}

    # ---- phase 1: card facts ------------------------------------------------
    card = card_facts()
    print(card)
    print(
        f"phase 1 card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"device 0 {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()}"
    )
    if args.phase == 24:
        return sharded_phase_alone(dev, card)
    if args.phase == 25:
        so, seconds = build.build()
        print(f"phase 2 build: {so.name} in {seconds:.2f} s")
        t0 = time.perf_counter()
        bench_phase(card)
        print(f"phase 25 took {time.perf_counter() - t0:.2f} s")
        print(card)
        return 0
    if args.phase == 26:
        so, seconds = build.build()
        print(f"phase 2 build: {so.name} in {seconds:.2f} s")
        golden = np.load(FIXTURE)
        t0 = time.perf_counter()
        tile_phase(dev, card, golden["bc7_in"], golden["bc7_out"].view(np.uint8).reshape(-1, 16))
        print(f"phase 26 took {time.perf_counter() - t0:.2f} s")
        print(card)
        return 0

    # ---- phase 2: build -----------------------------------------------------
    so, seconds = build.build()
    ptxas = build.ptxas_report()
    print(f"phase 2 build: nvcc {' '.join(build.NVCC_FLAGS)} -> {so.name} in {seconds:.2f} s "
          f"(one nvcc per source, in parallel, then one link)")
    for t in TARGETS:
        for m in range(19):
            require((t, m) in ptxas and "registers" in ptxas[(t, m)], f"no ptxas report for {t} mode {m}")
            r = ptxas[(t, m)]
            print(
                f"  ptxas uastc_kernel<{OP_NAME[t]}<{m}>>: {r['registers']} registers, {r['stack']} B stack, "
                f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads"
            )
    for kind in etc1s.KINDS:
        require(("etc1s", kind) in ptxas and "registers" in ptxas[("etc1s", kind)], f"no ptxas report for {kind}")
        r = ptxas[("etc1s", kind)]
        print(f"  ptxas etc1s_kernel<{etc1s.KINDS.index(kind)}> ({kind}): {r['registers']} registers, {r['stack']} B "
              f"stack, {r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    for stage in bc7_stages.STAGES:
        for m in bc7_stages.STAGE_MODES[stage]:
            key = (f"bc7_stage/{stage}", m)
            require(key in ptxas and "registers" in ptxas[key], f"no ptxas report for T1 {stage} mode {m}")
            r = ptxas[key]
            print(f"  ptxas bc7_stage_kernel<{m}, {bc7_stages.STAGES.index(stage)}> ({stage}): {r['registers']} "
                  f"registers, {r['stack']} B stack, {r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
                  f"loads")
    r = ptxas.get(("probe", "fl_div255"), {})
    require("registers" in r, "no ptxas report for the fl_div255 probe")
    print(f"  ptxas fl_div255_probe_kernel: {r['registers']} registers, {r['stack']} B stack, {r['spill_stores']} B "
          f"spill stores, {r['spill_loads']} B spill loads")
    r = ptxas.get(("bc7", "tiles"), {})
    require("registers" in r, "no ptxas report for uastc_kernel_tiles<Bc7>")
    print(f"  ptxas uastc_kernel_tiles<Bc7>: {r['registers']} registers, {r['stack']} B stack, {r['spill_stores']} B "
          f"spill stores, {r['spill_loads']} B spill loads")
    require(len(ptxas) == 201, f"ptxas reports {len(ptxas)} kernels, expected 201")
    print("phase 2 ptxas json " + json.dumps({f"{t}/{m}": v for (t, m), v in sorted(ptxas.items(), key=str)}))
    sass = build.sass_counts()
    shape = {}  # (target, mode) -> (registers, resident warps per SM, SASS instructions)
    for t in TARGETS:
        for m in range(19):
            r = ptxas[(t, m)]
            require(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"{t} mode {m} spills: {r}")
            require((t, m) in sass, f"no SASS for {t} mode {m}")
            shape[(t, m)] = (r["registers"], kernels.resident_warps(t, m), sass[(t, m)])
            print(f"  shape uastc_kernel<{OP_NAME[t]}<{m}>>: {shape[(t, m)][0]} registers, {shape[(t, m)][1]} resident "
                  f"warps per SM at {KERNEL_THREADS} threads a CTA, {shape[(t, m)][2]} SASS instructions (cuobjdump "
                  f"-sass, NOPs left out)")
    print("phase 2 shape json " + json.dumps({f"{t}/{m}": v for (t, m), v in shape.items()}))
    t1_sass = {}
    for stage in bc7_stages.STAGES:
        for m in bc7_stages.STAGE_MODES[stage]:
            key = (f"bc7_stage/{stage}", m)
            require(key in sass, f"no SASS for T1 {stage} mode {m}")
            t1_sass[f"{stage}/{m}"] = sass[key]
    print("phase 2 T1 sass json " + json.dumps(t1_sass) + " (SASS instructions a thread of each "
          "bc7_stage_kernel<M, S>, cuobjdump -sass, NOPs left out)")

    golden = np.load(FIXTURE)
    lut = np_tables()["MODE_LUT"]
    golden_in = golden["bc7_in"]
    for t in TARGETS:
        require(np.array_equal(golden[f"{t}_in"], golden_in), f"golden {t} inputs differ from bc7's")
    golden_out = {t: golden[f"{t}_out"].view(np.uint8).reshape(len(golden_in), out_bytes[t]) for t in TARGETS}

    # ---- phases 3 and 6: kernel vs plain version per mode -------------------
    max_abs = {}

    def kernel_vs_plain(phase: int, t: str) -> None:
        rng = np.random.default_rng(SEED)
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        for m in range(19):
            blocks = torch.from_numpy(mode_blocks(rng, lut, golden_in, m)).to(dev)
            n = blocks.shape[0]
            worst = 0
            for index in (None, torch.randperm(n, generator=gen)[: n - 7].to(dev)):
                k_out = torch.zeros(n, out_bytes[t], dtype=torch.uint8, device=dev)
                k_err = torch.zeros(n, dtype=torch.bool, device=dev)
                p_out = torch.zeros_like(k_out)
                p_err = torch.zeros_like(k_err)
                kernels.mode_kernel(t, m)(blocks, index, k_out, k_err)
                plain[t](m, blocks, index, p_out, p_err)
                torch.cuda.synchronize()
                diff = int((k_out.to(torch.int32) - p_out.to(torch.int32)).abs().max())
                err_diff = int((k_err != p_err).sum())
                require(diff == 0 and err_diff == 0,
                        f"{t} mode {m} index={'perm' if index is not None else 'none'}: kernel differs "
                        f"from the plain version (max byte diff {diff}, {err_diff} err flags)")
                worst = max(worst, diff, err_diff)
            max_abs[(t, m)] = worst
            print(
                f"phase {phase} {t} mode {m:2d}: {n} blocks ({int(p_err.sum())} with err), kernel == plain "
                f"(tolerance 0, max abs err {worst}) [{card}]"
            )

    kernel_vs_plain(3, "bc7")

    # ---- phase 4: golden corpus through the API -----------------------------
    out, err = transcode_uastc_blocks(golden_in, "bc7", device="cuda")
    require(out.device.type == "cuda", "API result is not on the card")
    require(not bool(err.any()), "golden blocks flagged err")
    require(np.array_equal(out.cpu().numpy(), golden_out["bc7"]), "golden BC7 mismatch")
    bad = invalid_blocks()
    require(int(block_modes(torch.from_numpy(bad))[0]) == INVALID_MODE, "byte 69 is not invalid")
    _, err_bad = transcode_uastc_blocks(bad, "bc7", device="cuda")
    require(bool(err_bad.all()), "invalid mode / pattern not flagged")
    print(f"phase 4 golden: {len(golden_in)}/{len(golden_in)} BC7 pairs bit-exact on the card, "
          f"invalid mode and invalid pattern flagged [{card}]")

    # ---- phases 5 and 8: main path at full size ------------------------------
    reps = -(-N_FULL // len(golden_in))
    full_np = tiled_blocks(golden_in)
    full = torch.from_numpy(full_np).to(dev)
    expected_np = {t: np.tile(golden_out[t], (reps, 1))[:N_FULL] for t in TARGETS}
    ((order, counts),) = partition([full])
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    groups = {m: order[starts[m] : starts[m + 1]] for m in range(19) if counts[m]}
    results = {}

    def main_path(phase: int, t: str) -> None:
        expected = torch.from_numpy(expected_np[t]).to(dev)

        def as_bytes(o):
            return o.view(torch.uint8) if t == "rgba" else o

        transcode_uastc_blocks(full, t)  # warm-up (library load, allocator)
        torch.cuda.synchronize()

        kernels.reset_counts()
        out, err = transcode_uastc_blocks(full, t)
        # no synchronize: the comparisons below follow the launches on the
        # stream, so a launch that completed ahead of one before it would
        # show as a mismatch
        counted = check_launches(kernels, t, 1, "main path")
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(tuple(as_bytes(out).shape) == (N_FULL, out_bytes[t]), f"{t} full-size output shape")
        require(out.dtype == (torch.uint32 if t == "rgba" else torch.uint8), f"{t} output dtype {out.dtype}")
        require(bool(torch.equal(as_bytes(out), expected)), f"{t} full-size output differs from the tiled golden")
        require(not bool(err.any()), f"{t} full-size golden mix flagged err")
        require(plain_calls == 0, f"plain version called on the main path: {plain_calls}")
        print(f"phase {phase} {t} main path: {N_FULL} blocks bit-exact vs tiled golden; "
              f"{launch_text(kernels, t, counted)}; plain-version calls {plain_calls} [{card}]")
        del out, err

        k_out = torch.empty(N_FULL, out_bytes[t], dtype=torch.uint8, device=dev)
        k_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)

        def launches_alone():
            # as the dispatch launches another target's
            for m, idx in groups.items():
                kernels.mode_kernel(t, m)(full, idx, k_out, k_err, check_index=False)

        k_out.zero_()
        launches_alone()
        require(bool(torch.equal(k_out, expected)) and not bool(k_err.any()),
                f"{t} launches alone differ from the tiled golden outputs")
        call_times = times_ms(lambda: transcode_uastc_blocks(full, t))
        call_ms = statistics.median(call_times)
        call_q1, _, call_q3 = statistics.quantiles(call_times, n=4)
        launch_ms = median_ms(launches_alone)
        launch_dev_ms = median_ms(launches_alone, preload=True)
        tile_ms = (median_ms(lambda: kernels.tile_kernel(t)(full, k_out, k_err), preload=True)
                   if t in kernels.TILED else None)
        mode_ms = {m: median_ms(lambda m=m, idx=idx: kernels.mode_kernel(t, m)(full, idx, k_out, k_err,
                                                                             check_index=False),
                                preload=True)
                   for m, idx in groups.items()}
        perm_line = ""
        if t == "rgba":
            # the scatter of real files: each mode's rows in a random order,
            # so a warp's 32 rows are seldom neighbours
            gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
            perm = {m: idx[torch.randperm(len(idx), generator=gen).to(dev)] for m, idx in groups.items()}

            def perm_alone():
                for m, idx in perm.items():
                    kernels.mode_kernel(t, m)(full, idx, k_out, k_err, check_index=False)

            k_out.zero_()
            perm_alone()
            torch.cuda.synchronize()
            require(bool(torch.equal(k_out, expected)) and not bool(k_err.any()),
                    f"{t} launches through permuted indices differ from the tiled golden")
            perm_ms = median_ms(perm_alone, preload=True)
            perm_mode_ms = {m: median_ms(lambda m=m, idx=idx: kernels.mode_kernel(t, m)(full, idx, k_out, k_err,
                                                                                      check_index=False),
                                         preload=True)
                            for m, idx in perm.items()}
            del perm
            perm_line = (f"phase {phase} {t} permuted index [{card}]: each mode's index randomly permuted, output "
                         f"bit-exact vs tiled golden; 19 launches device time {perm_ms:.4f} ms (in-order index "
                         f"{launch_dev_ms:.4f} ms); per mode " + ", ".join(f"{m} {v:.4f}" for m, v in perm_mode_ms.items())
                         + " ms")
        del k_out, k_err

        p_out = torch.empty(N_FULL, out_bytes[t], dtype=torch.uint8, device=dev)
        p_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)
        plain_mode_ms = {m: median_ms(lambda m=m, idx=idx: plain[t](m, full, idx, p_out, p_err), PLAIN_REPS)
                         for m, idx in groups.items()}
        require(bool(torch.equal(p_out, expected)), f"{t} plain version at full size differs from golden")

        def plain_path():
            ((po, pc),) = partition([full])
            s = 0
            for m, c in enumerate(pc):
                if c:
                    plain[t](m, full, po[s : s + c], p_out, p_err)
                s += c

        plain_ms = median_ms(plain_path, PLAIN_REPS)
        del p_out, p_err, expected
        torch.cuda.empty_cache()
        bound_all = N_FULL * block_bytes[t] / HBM_BYTES_PER_S * 1e3
        index_ms = N_FULL * INDEX_BYTES / HBM_BYTES_PER_S * 1e3
        print(f"phase {phase} {t} time [{card}]: transcode_uastc_blocks {call_ms:.4f} ms = "
              f"{mtex(N_FULL, call_ms):.1f} Mtexels/s (median of {REPS}, CUDA events; quartiles "
              f"{call_q1:.4f}-{call_q3:.4f} ms, min {min(call_times):.4f}, max {max(call_times):.4f})")
        print(f"phase {phase} {t} time [{card}]: 19 kernel launches alone (output bit-exact vs tiled golden "
              f"with no synchronize before the check), as called {launch_ms:.4f} ms = "
              f"{mtex(N_FULL, launch_ms):.1f} Mtexels/s; device time {launch_dev_ms:.4f} ms = "
              f"{mtex(N_FULL, launch_dev_ms):.1f} Mtexels/s; HBM bound {bound_all:.4f} ms "
              f"({block_bytes[t]} B a block at 3.35 TB/s, {100 * bound_all / launch_dev_ms:.1f}% of device time); "
              f"the index list adds {INDEX_BYTES} B a block, {index_ms:.4f} ms at 3.35 TB/s; the per-mode "
              f"launches below sum to {sum(mode_ms.values()):.4f} ms")
        if t in kernels.TILED:
            print(f"phase {phase} {t} time [{card}]: the call's one tile-kernel launch, device time {tile_ms:.4f} ms; "
                  f"host share of the call {call_ms - tile_ms:.4f} ms (call minus that)")
        else:
            print(f"phase {phase} {t} time [{card}]: partition and host share of the call "
                  f"{call_ms - launch_ms:.4f} ms (call minus launches as called)")
        print(f"phase {phase} {t} time [{card}]: plain PyTorch version (partition and 19 plain calls), same size "
              f"{plain_ms:.4f} ms = "
              f"{mtex(N_FULL, plain_ms):.1f} Mtexels/s (as called, median of {PLAIN_REPS})")
        for m in groups:
            print(f"phase {phase} {t} mode {m:2d} [{card}]: {counts[m]} blocks, kernel device time (one launch) "
                  f"{mode_ms[m]:.4f} ms = {mtex(counts[m], mode_ms[m]):.1f} Mtexels/s; plain as called "
                  f"{plain_mode_ms[m]:.4f} ms = {mtex(counts[m], plain_mode_ms[m]):.1f} Mtexels/s")
        if perm_line:
            print(perm_line)
        results[t] = dict(launches=counted[0], tile_launches=counted[1], tile_ms=tile_ms, plain_ms=plain_ms,
                          mode_ms=mode_ms, plain_mode_ms=plain_mode_ms)

    main_path(5, "bc7")

    # ---- phase 6: ASTC and RGBA kernels vs plain versions --------------------
    for t in ("astc", "rgba"):
        kernel_vs_plain(6, t)

    # ---- phases 7 and 11: golden corpus through the API ------------------------
    def golden_api(phase: int, targets, block_fns) -> None:
        for t in targets:
            out, err = transcode_uastc_blocks(golden_in, t, device="cuda")
            require(out.device.type == "cuda", "API result is not on the card")
            require(not bool(err.any()), f"golden blocks flagged err ({t})")
            got = out.cpu().numpy()
            require(np.array_equal(got, golden[f"{t}_out"]), f"golden {t} mismatch")
            _, err_bad = transcode_uastc_blocks(bad, t, device="cuda")
            require(bool(err_bad.all()), f"invalid mode / pattern not flagged ({t})")
        for fn, t in block_fns:
            one = fn(golden_in[100])
            require(np.array_equal(np.frombuffer(one, np.uint8) if isinstance(one, bytes) else one,
                                   golden[f"{t}_out"][100]), f"{fn.__name__} of golden block 100")
            for block, msg in ((bad[0], "invalid mode index"), (bad[1], "block pattern is not valid")):
                try:
                    fn(block)
                except BasisError as e:
                    require(str(e) == msg, f"{fn.__name__}: message {e!r}, expected {msg!r}")
                else:
                    raise RuntimeError(f"{fn.__name__} accepted a bad block")
        print(f"phase {phase} golden: " + " and ".join(f"{len(golden_in)}/{len(golden_in)} {t.upper()}"
                                                       for t in targets)
              + f" pairs bit-exact on the card; invalid mode and pattern flagged, block functions raise "
              f"the reference's messages [{card}]")

    golden_api(7, ("astc", "rgba"), ((transcode_uastc_block_to_astc, "astc"), (unpack_uastc_block_to_rgba, "rgba")))

    # ---- phase 8: ASTC and RGBA main paths at full size ----------------------
    for t in ("astc", "rgba"):
        main_path(8, t)

    # ---- phases 9 and 13: the file path at full size ---------------------------
    per_slice = SLICE_BLOCKS_X * SLICE_BLOCKS_X
    t0 = time.perf_counter()
    slices = uastc_texture_slices(full_np)
    buf = write_uastc_basis(slices)
    print(f"phase 9 file: {SLICES} slices of {4 * SLICE_BLOCKS_X}x{4 * SLICE_BLOCKS_X} texels, {len(buf)} bytes, "
          f"written in {time.perf_counter() - t0:.2f} s (host)")
    readers = {"bc7": read_to_bc7, "astc": read_to_astc, "rgba": lambda b: read_to_rgba(b)[1],
               "etc1": read_to_etc1, "etc2": read_to_etc2}
    w = 4 * SLICE_BLOCKS_X
    file_ms = {}

    def file_path(phase: int, t: str) -> None:
        reader = readers[t]
        reader(buf)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_counts()
        images = reader(buf)
        torch.cuda.synchronize()
        launches = launch_text(kernels, t, check_launches(kernels, t, 1, "file"))
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(plain_calls == 0, f"plain version called on the file path: {plain_calls}")
        require(len(images) == SLICES, f"{t}: {len(images)} images")
        stride = 4 * SLICE_BLOCKS_X * 4 if t == "rgba" else out_bytes[t] * SLICE_BLOCKS_X
        for i, img in enumerate(images):
            require((img.w, img.h, img.stride) == (w, w, stride), f"{t} image {i}: {img.w}x{img.h} stride {img.stride}")
            exp = expected_np[t][i * per_slice : (i + 1) * per_slice]
            if t == "rgba":  # [by, bx, y, x] texel words -> raster rows, on the host
                exp = exp.view("<u4").reshape(SLICE_BLOCKS_X, SLICE_BLOCKS_X, 4, 4).transpose(0, 2, 1, 3)
            exp = torch.from_numpy(np.ascontiguousarray(exp).view(np.uint8).reshape(-1)).to(dev)
            require(img.data.device.type == "cuda" and img.data.dtype == torch.uint8, f"{t} image {i} data")
            require(bool(torch.equal(img.data, exp)), f"{t} image {i} differs from the golden outputs")
        del images

        descs = basis.read_slice_descs(buf, basis.read_header(buf))
        blocks = basis.uastc_host_payload(buf, descs)[0].to(dev)
        out, err = transcode_blocks(blocks, t)
        slices_rows = [(d, k * per_slice, (k + 1) * per_slice) for k, d in enumerate(descs)]
        split = {
            "header + CRC, host": host_ms(lambda: basis._validated(buf)),
            "H2D copy": host_ms(lambda: basis.uastc_host_payload(buf, descs)[0].to(dev)),
            "transcode_blocks": host_ms(lambda: transcode_blocks(blocks, t)),
            "err check": host_ms(lambda: basis._check_errs(err, blocks)),
        }
        if t == "rgba":
            split["RGBA reorder"] = host_ms(lambda: basis.rgba_images(out, slices_rows))
        split["whole call"] = host_ms(lambda: reader(buf))
        file_ms[t] = split["whole call"]
        del blocks, out, err
        print(f"phase {phase} {t} file [{card}]: {SLICES} images bit-exact (w, h, stride, data); {launches}; "
              f"plain-version calls {plain_calls}")
        print(f"phase {phase} {t} split [{card}] (host clock + sync, median of {FILE_REPS}, ms): "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
              + f" = {mtex(N_FULL, split['whole call']):.1f} Mtexels/s whole call")
        torch.cuda.empty_cache()

    corrupt = bytearray(buf)
    corrupt[-1000] ^= 0x10
    bad_file = [dict(s) for s in slices]
    bad_blocks = bad_file[5]["blocks"].copy()
    bad_blocks[123] = bad[0]  # invalid mode in slice 5 ...
    bad_file[5]["blocks"] = bad_blocks
    later = bad_file[6]["blocks"].copy()
    later[7] = bad[1]  # ... comes before an invalid pattern in slice 6
    bad_file[6]["blocks"] = later
    bad_buf = write_uastc_basis(bad_file)

    def file_errors(phase: int, targets) -> None:
        for name, b, msg in (("corrupt CRC", bytes(corrupt), "Data CRC16 failed"),
                             ("invalid blocks", bad_buf, "invalid mode index")):
            for t in targets:
                try:
                    readers[t](b)
                except BasisError as e:
                    require(str(e) == msg, f"{name} via {t}: message {e!r}, expected {msg!r}")
                else:
                    raise RuntimeError(f"{name} file accepted by read_to_{t}")
        print(f"phase {phase} errors: a corrupt-CRC file and a file with invalid blocks raise the reference's "
              f"messages through " + "/".join(f"read_to_{t}" for t in targets) + f" [{card}]")

    for t in ("bc7", "astc", "rgba"):
        file_path(9, t)
    file_errors(9, ("bc7", "astc", "rgba"))

    # ---- phases 10-13: the ETC1 and ETC2 kernels (K4, K5) ------------------------
    for t in ("etc1", "etc2"):
        kernel_vs_plain(10, t)
    golden_api(11, ("etc1", "etc2"), ((transcode_uastc_block_to_etc1, "etc1"), (transcode_uastc_block_to_etc2, "etc2")))
    for t in ("etc1", "etc2"):
        main_path(12, t)
    for t in ("etc1", "etc2"):
        file_path(13, t)
    file_errors(13, ("etc1", "etc2"))
    torch.cuda.empty_cache()

    # ---- phases 14-16: the ETC1S back-end (K6-K9) and its files ----------------
    etc1s_max_abs = etc1s_kernel_vs_plain(etc1s, dev, card)
    endpoints, selectors, idx_np = etc1s_streams()
    idx = [torch.from_numpy(a).to(dev) for a in idx_np]
    etc1s_results = etc1s_main_path(etc1s, dev, card, endpoints, selectors, idx)
    etc1s_files = etc1s_file_path(etc1s, basis, {"rgba": lambda b: read_to_rgba(b)[1], "etc1": read_to_etc1}, dev,
                                  card, endpoints, selectors, idx_np, idx)
    del idx
    torch.cuda.empty_cache()

    # ---- phases 17-24: P, T1, the corpus layer, the CLI and the sharded path ---
    def timed(phase: int, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"phase {phase} took {time.perf_counter() - t0:.2f} s")
        return out

    probe = timed(17, lambda: probe_phase(dev, card))
    timed(18, lambda: stages_vs_plain(bc7_stages, dev, card, lut, golden_in))
    t1 = timed(19, lambda: stages_timing(bc7_stages, kernels, dev, card, results["bc7"]["mode_ms"], counts,
                                         golden_in, golden_out["bc7"], sass))
    timed(20, lambda: corpus_phase(dev, card, full_np, full, kernels, etc1s))
    timed(21, lambda: pipeline_phase(dev, card, full_np, endpoints, selectors, read_to_rgba, basis))
    timed(22, lambda: cli_phase(card, full_np, endpoints, selectors))
    timed(23, lambda: contiguous_modes(kernels, dev, card, golden_in, golden_out, block_bytes, shape,
                                       {t: results[t]["mode_ms"] for t in TARGETS}, counts))
    timed(24, lambda: sharded_phase(dev, card, full_np, full, buf, etc1s_files, endpoints, selectors, idx_np, bad))
    torch.cuda.empty_cache()
    timed(25, lambda: bench_phase(card))
    timed(26, lambda: tile_phase(dev, card, golden_in, golden_out["bc7"]))

    result = {
        "kernels": [
            {
                "name": f"uastc_kernel<{OP_NAME[t]}<{m}>>",
                "route": "cuda",
                "source": f"basisu_rs_tpu_torch/csrc/uastc_{t}.cu",
                "replaces": REPLACES,
                "launches": results[t]["launches"][m],
                "max_abs_err": max_abs[(t, m)],
                "ms": results[t]["mode_ms"][m],
                "plain_ms": results[t]["plain_mode_ms"][m],
                "bound_ms": counts[m] * block_bytes[t] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
            }
            for t in TARGETS
            for m in range(19)
        ]
        + [
            {
                "name": f"uastc_kernel_tiles<{OP_NAME[t]}>",
                "route": "cuda",
                "source": f"basisu_rs_tpu_torch/csrc/uastc_{t}.cu",
                "replaces": REPLACES,
                "launches": results[t]["tile_launches"],
                "max_abs_err": 0.0,  # phases 5 and 26 require every byte and err flag equal
                "ms": results[t]["tile_ms"],
                "plain_ms": results[t]["plain_ms"],
                "bound_ms": N_FULL * block_bytes[t] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
            }
            for t in TARGETS
            if t in kernels.TILED
        ]
        + [
            {
                "name": f"etc1s_kernel<{etc1s.KINDS.index(kind)}> ({kind})",
                "route": "cuda",
                "source": "basisu_rs_tpu_torch/csrc/etc1s.cu",
                "replaces": f"{ETC1S_REPLACES} (_build(\"{kind}\"))",
                "launches": etc1s_results[kind]["launches"],
                "max_abs_err": etc1s_max_abs[kind],
                "ms": etc1s_results[kind]["ms"],
                "plain_ms": etc1s_results[kind]["plain_ms"],
                "bound_ms": N_FULL * etc1s_block_bytes(etc1s, kind) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
            }
            for kind in etc1s.KINDS
        ]
        + [
            {
                "name": f"bc7_stage_kernel<{m}, {bc7_stages.STAGES.index(stage)}> ({stage})",
                "route": "cuda",
                "source": "basisu_rs_tpu_torch/csrc/uastc_bc7_stages.cu",
                "replaces": f"{T1_REPLACES} (closure :{T1_CLOSURES[stage]})",
                "launches": r["launches"],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["blocks"] * T1_BLOCK_BYTES / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
            }
            for (m, stage), r in t1.items()
        ]
        + [
            {
                "name": "fl_div255_probe_kernel",
                "route": "cuda",
                "source": "basisu_rs_tpu_torch/csrc/fl_div255_probe.cu",
                "replaces": PROBE_REPLACES,
                "bound_by": "bytes",
                **probe,
            }
        ]
    }
    print(json.dumps(result))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
