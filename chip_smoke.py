#!/usr/bin/env python3
"""Drive the PyTorch port's UASTC paths (to BC7, ASTC, RGBA, ETC1 and ETC2,
for blocks and for .basis files) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. card facts (nvidia-smi name and power limit, torch and CUDA versions);
  2. nvcc build of csrc/*.cu for sm_90a (one nvcc per source, in parallel),
     with seconds and the ptxas register/spill report of all 95 kernels
     (K1 BC7, K2 ASTC, K3 RGBA, K4 ETC1, K5 ETC2, x 19 UASTC modes);
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
     launch per mode and no plain-version call; then CUDA-event timings of
     the whole call, of the 19 launches alone (as called, and device time
     with the stream preloaded), of each mode's kernel on its group (device
     time), and of the plain version at the same size (as called);
  6. as phase 3, for the ASTC and RGBA kernels;
  7. the golden corpus to ASTC and RGBA through the API on the card, and the
     invalid-mode and invalid-pattern blocks through the block functions,
     which must raise the reference's messages;
  8. as phase 5, for ASTC (128 MiB in, 128 MiB out) and RGBA (128 MiB in,
     512 MiB out);
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
 13. as phase 9, for `read_to_etc1` and `read_to_etc2` on the same file.
The last two lines before the final one are a JSON line of per-kernel
results and the card's name and power limit; the final line is the
`{"ok": true, "device": ...}` result.  Imports torch, numpy and
basisu_rs_tpu_torch only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_blocks.npz"
N_FULL = 1 << 23
N_RANDOM = 1 << 16
SEED = 0
REPS = 10
PLAIN_REPS = 5
FILE_REPS = 3
PRELOAD_CYCLES = 20_000_000  # ~10 ms of sleep at 2 GHz: longer than any enqueue timed here
TEXELS_PER_BLOCK = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
INDEX_BYTES = 8  # the dispatch's int64 index of a block, read once by its launch
TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")
OP_NAME = {"bc7": "Bc7", "astc": "Astc", "rgba": "Rgba", "etc1": "Etc1", "etc2": "Etc2"}
REPLACES = "basisu_rs_tpu/ops/pallas_kernels.py:150"
SLICES, SLICE_BLOCKS_X = 8, 1024  # 8 slices of 1024x1024 blocks = 2^23 blocks


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_facts() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def times_ms(fn, reps: int = REPS, preload: bool = False) -> list:
    """fn's time between two CUDA events, in ms, for each of `reps` runs.

    As called (preload=False) the events also span the GPU's wait for the
    host to enqueue fn's launches, which is what a caller sees.  With
    preload=True a sleep kernel holds the stream while fn enqueues, so the
    events span only the device's own time for fn's kernels."""
    times = []
    for _ in range(reps):
        if preload:
            torch.cuda._sleep(PRELOAD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


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


def main() -> int:
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
    from basisu_rs_tpu_torch.ops import build, kernels
    from basisu_rs_tpu_torch.ops.dispatch import block_modes, transcode_blocks
    from basisu_rs_tpu_torch.tables import INVALID_MODE, MODES, np_tables

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
    print("phase 2 ptxas json " + json.dumps({f"{t}/{m}": v for (t, m), v in sorted(ptxas.items())}))

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
    bad = np.zeros((2, 16), np.uint8)
    bad[0, 0] = 69  # 7-bit code with MODE_LUT value 19: invalid mode
    bad[1, 0] = 0x1D  # a mode-2 code, pattern field set to 31 (>= 30 patterns)
    ofs = MODES[2].field_offsets["pattern"]
    for b in range(5):
        bad[1, (ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    require(int(block_modes(torch.from_numpy(bad))[0]) == INVALID_MODE, "byte 69 is not invalid")
    _, err_bad = transcode_uastc_blocks(bad, "bc7", device="cuda")
    require(bool(err_bad.all()), "invalid mode / pattern not flagged")
    print(f"phase 4 golden: {len(golden_in)}/{len(golden_in)} BC7 pairs bit-exact on the card, "
          f"invalid mode and invalid pattern flagged [{card}]")

    # ---- phases 5 and 8: main path at full size ------------------------------
    reps = -(-N_FULL // len(golden_in))
    full_np = np.tile(golden_in, (reps, 1))[:N_FULL]
    full = torch.from_numpy(full_np).to(dev)
    expected_np = {t: np.tile(golden_out[t], (reps, 1))[:N_FULL] for t in TARGETS}
    modes = block_modes(full)
    order = torch.argsort(modes, stable=True)
    counts = torch.bincount(modes, minlength=INVALID_MODE + 1).tolist()
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
        torch.cuda.synchronize()
        launches = kernels.launch_counts()[t]
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(tuple(as_bytes(out).shape) == (N_FULL, out_bytes[t]), f"{t} full-size output shape")
        require(out.dtype == (torch.uint32 if t == "rgba" else torch.uint8), f"{t} output dtype {out.dtype}")
        require(bool(torch.equal(as_bytes(out), expected)), f"{t} full-size output differs from the tiled golden")
        require(not bool(err.any()), f"{t} full-size golden mix flagged err")
        require(launches == [1] * 19, f"{t} launch counts {launches}, expected one per mode")
        require(plain_calls == 0, f"plain version called on the main path: {plain_calls}")
        print(f"phase {phase} {t} main path: {N_FULL} blocks bit-exact vs tiled golden; launches per mode "
              f"{launches}; plain-version calls {plain_calls} [{card}]")
        del out, err

        k_out = torch.empty(N_FULL, out_bytes[t], dtype=torch.uint8, device=dev)
        k_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)

        def launches_alone():
            for m, idx in groups.items():
                kernels.mode_kernel(t, m)(full, idx, k_out, k_err, check_index=False)

        call_times = times_ms(lambda: transcode_uastc_blocks(full, t))
        call_ms = statistics.median(call_times)
        call_q1, _, call_q3 = statistics.quantiles(call_times, n=4)
        launch_ms = median_ms(launches_alone)
        launch_dev_ms = median_ms(launches_alone, preload=True)
        mode_ms = {m: median_ms(lambda m=m, idx=idx: kernels.mode_kernel(t, m)(full, idx, k_out, k_err,
                                                                             check_index=False),
                                preload=True)
                   for m, idx in groups.items()}
        del k_out, k_err

        p_out = torch.empty(N_FULL, out_bytes[t], dtype=torch.uint8, device=dev)
        p_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)
        plain_mode_ms = {m: median_ms(lambda m=m, idx=idx: plain[t](m, full, idx, p_out, p_err), PLAIN_REPS)
                         for m, idx in groups.items()}
        require(bool(torch.equal(p_out, expected)), f"{t} plain version at full size differs from golden")

        def plain_path():
            pm = block_modes(full)
            po = torch.argsort(pm, stable=True)
            pc = torch.bincount(pm, minlength=INVALID_MODE + 1).tolist()
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
        print(f"phase {phase} {t} time [{card}]: 19 kernel launches alone, as called {launch_ms:.4f} ms = "
              f"{mtex(N_FULL, launch_ms):.1f} Mtexels/s; device time {launch_dev_ms:.4f} ms = "
              f"{mtex(N_FULL, launch_dev_ms):.1f} Mtexels/s; HBM bound {bound_all:.4f} ms "
              f"({block_bytes[t]} B a block at 3.35 TB/s, {100 * bound_all / launch_dev_ms:.1f}% of device time); "
              f"the index list adds {INDEX_BYTES} B a block, {index_ms:.4f} ms at 3.35 TB/s")
        print(f"phase {phase} {t} time [{card}]: partition and host share of the call "
              f"{call_ms - launch_ms:.4f} ms (call minus launches as called)")
        print(f"phase {phase} {t} time [{card}]: plain PyTorch version, same size {plain_ms:.4f} ms = "
              f"{mtex(N_FULL, plain_ms):.1f} Mtexels/s (as called, median of {PLAIN_REPS})")
        for m in groups:
            print(f"phase {phase} {t} mode {m:2d} [{card}]: {counts[m]} blocks, kernel device time "
                  f"{mode_ms[m]:.4f} ms = {mtex(counts[m], mode_ms[m]):.1f} Mtexels/s; plain as called "
                  f"{plain_mode_ms[m]:.4f} ms = {mtex(counts[m], plain_mode_ms[m]):.1f} Mtexels/s")
        results[t] = dict(launches=launches, mode_ms=mode_ms, plain_mode_ms=plain_mode_ms)

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
    slices = [
        dict(blocks=full_np[i * per_slice : (i + 1) * per_slice], nbx=SLICE_BLOCKS_X, nby=SLICE_BLOCKS_X,
             orig_width=4 * SLICE_BLOCKS_X, orig_height=4 * SLICE_BLOCKS_X, image_index=0, level_index=0)
        for i in range(SLICES)
    ]
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
        launches = kernels.launch_counts()[t]
        plain_calls = sum(sum(c) for c in kernels.plain_call_counts().values())
        require(launches == [1] * 19, f"{t} file launch counts {launches}, expected one per mode per file")
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
        blocks, _ = basis.uastc_payload(buf, descs, dev)
        out, err = transcode_blocks(blocks, t)
        slices_rows = [(d, k * per_slice, (k + 1) * per_slice) for k, d in enumerate(descs)]
        split = {
            "header + CRC, host": host_ms(lambda: basis._validated(buf)),
            "H2D copy": host_ms(lambda: basis.uastc_payload(buf, descs, dev)),
            "transcode_blocks": host_ms(lambda: transcode_blocks(blocks, t)),
            "err check": host_ms(lambda: basis._check_errs(err, blocks)),
        }
        if t == "rgba":
            split["RGBA reorder"] = host_ms(lambda: basis.rgba_images(out, slices_rows))
        split["whole call"] = host_ms(lambda: reader(buf))
        file_ms[t] = split["whole call"]
        del blocks, out, err
        print(f"phase {phase} {t} file [{card}]: {SLICES} images bit-exact (w, h, stride, data); launches per mode "
              f"{launches}; plain-version calls {plain_calls}")
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
