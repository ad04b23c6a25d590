#!/usr/bin/env python3
"""Drive the PyTorch port's UASTC -> BC7 main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. card facts (nvidia-smi name and power limit, torch and CUDA versions);
  2. nvcc build of csrc/*.cu for sm_90a, with seconds and the per-mode
     ptxas register/spill report;
  3. per UASTC mode 0-18: the CUDA kernel against its plain PyTorch version
     on the card, on that mode's golden blocks plus 65,536 seeded random
     blocks of the mode (invalid pattern indices included), bit-exact;
  4. the golden corpus through `transcode_uastc_blocks(..., device="cuda")`,
     plus an invalid-mode and an invalid-pattern block that must set err;
  5. the main path at full size: 2^23 device-resident blocks of the golden
     all-mode mix through `transcode_uastc_blocks`, checked against the
     tiled golden outputs, with launch counters that must show one launch
     per mode and no plain-version call; then CUDA-event timings of the
     whole call, of the 19 launches alone (as called, and device time with
     the stream preloaded), of each mode's kernel on its group (device
     time), and of the plain version at the same size (as called).
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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_blocks.npz"
N_FULL = 1 << 23
N_RANDOM = 1 << 16
SEED = 0
REPS = 10
PRELOAD_CYCLES = 20_000_000  # ~10 ms of sleep at 2 GHz: longer than any enqueue timed here
TEXELS_PER_BLOCK = 16
KERNEL_SOURCE = "basisu_rs_tpu_torch/csrc/uastc_bc7.cu"
REPLACES = "basisu_rs_tpu/ops/pallas_kernels.py:150"


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

    from basisu_rs_tpu_torch import transcode_uastc_blocks
    from basisu_rs_tpu_torch.ops import bc7, build, kernels
    from basisu_rs_tpu_torch.ops.dispatch import block_modes
    from basisu_rs_tpu_torch.tables import INVALID_MODE, MODES, np_tables

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

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
    print(f"phase 2 build: nvcc {' '.join(build.NVCC_FLAGS)} -> {so.name} in {seconds:.2f} s")
    for m in range(19):
        require(m in ptxas and "registers" in ptxas[m], f"no ptxas report for mode {m}")
        r = ptxas[m]
        print(
            f"  ptxas uastc_bc7_kernel<{m}>: {r['registers']} registers, {r['stack']} B stack, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads"
        )
    print("phase 2 ptxas json " + json.dumps(ptxas, sort_keys=True))

    # ---- phase 3: kernel vs plain version per mode --------------------------
    golden = np.load(FIXTURE)
    golden_in, golden_out = golden["bc7_in"], golden["bc7_out"]
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    max_abs = {}
    for m in range(19):
        blocks = torch.from_numpy(mode_blocks(rng, lut, golden_in, m)).to(dev)
        n = blocks.shape[0]
        worst = 0
        for index in (None, torch.randperm(n, generator=gen)[: n - 7].to(dev)):
            k_out = torch.zeros_like(blocks)
            k_err = torch.zeros(n, dtype=torch.bool, device=dev)
            p_out = torch.zeros_like(blocks)
            p_err = torch.zeros(n, dtype=torch.bool, device=dev)
            kernels.bc7_mode_kernel(m)(blocks, index, k_out, k_err)
            bc7.transcode_rows(m, blocks, index, p_out, p_err)
            torch.cuda.synchronize()
            diff = int((k_out.to(torch.int32) - p_out.to(torch.int32)).abs().max())
            err_diff = int((k_err != p_err).sum())
            require(diff == 0 and err_diff == 0,
                    f"mode {m} index={'perm' if index is not None else 'none'}: kernel differs "
                    f"from the plain version (max byte diff {diff}, {err_diff} err flags)")
            worst = max(worst, diff, err_diff)
        max_abs[m] = worst
        print(
            f"phase 3 mode {m:2d}: {n} blocks ({int(p_err.sum())} with err), kernel == plain "
            f"(tolerance 0, max abs err {worst}) [{card}]"
        )

    # ---- phase 4: golden corpus through the API -----------------------------
    out, err = transcode_uastc_blocks(golden_in, "bc7", device="cuda")
    require(out.device.type == "cuda", "API result is not on the card")
    require(not bool(err.any()), "golden blocks flagged err")
    require(np.array_equal(out.cpu().numpy(), golden_out), "golden BC7 mismatch")
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

    # ---- phase 5: main path at full size ------------------------------------
    reps = -(-N_FULL // len(golden_in))
    full = torch.from_numpy(np.tile(golden_in, (reps, 1))[:N_FULL]).to(dev)
    expected = torch.from_numpy(np.tile(golden_out, (reps, 1))[:N_FULL]).to(dev)
    transcode_uastc_blocks(full, "bc7")  # warm-up (library load, allocator)
    torch.cuda.synchronize()

    kernels.reset_counts()
    out, err = transcode_uastc_blocks(full, "bc7")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    plain_calls = kernels.plain_call_counts()
    require(out.shape == (N_FULL, 16) and out.dtype == torch.uint8, "full-size output shape")
    require(bool(torch.equal(out, expected)), "full-size output differs from the tiled golden BC7")
    require(not bool(err.any()), "full-size golden mix flagged err")
    require(launches == [1] * 19, f"launch counts {launches}, expected one per mode")
    require(sum(plain_calls) == 0, f"plain version called on the main path: {plain_calls}")
    print(f"phase 5 main path: {N_FULL} blocks bit-exact vs tiled golden; launches per mode "
          f"{launches}; plain-version calls {sum(plain_calls)} [{card}]")

    # partition once, to time the launches alone and each mode on its group
    modes = block_modes(full)
    order = torch.argsort(modes, stable=True)
    counts = torch.bincount(modes, minlength=INVALID_MODE + 1).tolist()
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    groups = {m: order[starts[m] : starts[m + 1]] for m in range(19) if counts[m]}
    k_out = torch.empty_like(full)
    k_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)

    def launches_alone():
        for m, idx in groups.items():
            kernels.bc7_mode_kernel(m)(full, idx, k_out, k_err)

    call_times = times_ms(lambda: transcode_uastc_blocks(full, "bc7"))
    call_ms = statistics.median(call_times)
    call_q1, _, call_q3 = statistics.quantiles(call_times, n=4)
    launch_ms = median_ms(launches_alone)
    launch_dev_ms = median_ms(launches_alone, preload=True)
    mode_ms = {m: median_ms(lambda m=m, idx=idx: kernels.bc7_mode_kernel(m)(full, idx, k_out, k_err),
                            preload=True)
               for m, idx in groups.items()}

    p_out = torch.empty_like(full)
    p_err = torch.empty(N_FULL, dtype=torch.bool, device=dev)
    plain_mode_ms = {m: median_ms(lambda m=m, idx=idx: bc7.transcode_rows(m, full, idx, p_out, p_err))
                     for m, idx in groups.items()}
    require(bool(torch.equal(p_out, expected)), "plain version at full size differs from golden")

    def plain_path():
        pm = block_modes(full)
        po = torch.argsort(pm, stable=True)
        pc = torch.bincount(pm, minlength=INVALID_MODE + 1).tolist()
        s = 0
        for m, c in enumerate(pc):
            if c:
                bc7.transcode_rows(m, full, po[s : s + c], p_out, p_err)
            s += c

    plain_ms = median_ms(plain_path)
    print(f"phase 5 time [{card}]: transcode_uastc_blocks {call_ms:.4f} ms = "
          f"{mtex(N_FULL, call_ms):.1f} Mtexels/s (median of {REPS}, CUDA events; quartiles "
          f"{call_q1:.4f}-{call_q3:.4f} ms, min {min(call_times):.4f}, max {max(call_times):.4f})")
    print(f"phase 5 time [{card}]: 19 kernel launches alone, as called {launch_ms:.4f} ms = "
          f"{mtex(N_FULL, launch_ms):.1f} Mtexels/s; device time {launch_dev_ms:.4f} ms = "
          f"{mtex(N_FULL, launch_dev_ms):.1f} Mtexels/s")
    print(f"phase 5 time [{card}]: partition and host share of the call "
          f"{call_ms - launch_ms:.4f} ms (call minus launches as called)")
    print(f"phase 5 time [{card}]: plain PyTorch version, same size {plain_ms:.4f} ms = "
          f"{mtex(N_FULL, plain_ms):.1f} Mtexels/s (as called)")
    for m in groups:
        print(f"phase 5 mode {m:2d} [{card}]: {counts[m]} blocks, kernel device time {mode_ms[m]:.4f} ms = "
              f"{mtex(counts[m], mode_ms[m]):.1f} Mtexels/s; plain as called {plain_mode_ms[m]:.4f} ms = "
              f"{mtex(counts[m], plain_mode_ms[m]):.1f} Mtexels/s")

    result = {
        "kernels": [
            {
                "name": f"uastc_bc7_kernel<{m}>",
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES,
                "launches": launches[m],
                "max_abs_err": max_abs[m],
                "ms": mode_ms[m],
                "plain_ms": plain_mode_ms[m],
            }
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
