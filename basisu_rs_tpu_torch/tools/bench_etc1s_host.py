"""Throughput of the port's C++ ETC1S entropy front-end
(`container/etc1s_frontend.cpp`, one slice a `decode_slice` call), in
Mblocks/s, on one core and on many threads.

    python -m basisu_rs_tpu_torch.tools.bench_etc1s_host [--blocks 1048576] [--reps 5] [--workers N]

Counterpart of the JAX system's `tools/bench_etc1s_host.py`, on the port's
writer (`container/writer.py` `write_etc1s_basis_fuzz`) and front-end
(`container/etc1s_frontend.py` `_NativeModels`, which `ops.build` builds
with g++ at first use; a failed build raises).  Host only: it needs no
card.  The front-end's state machine is serial within a slice, so host
throughput scales across slices: threads decode independent slices
concurrently, sharing one decoder handle, which `decode_slice` only reads
(`decode_slice_impl` takes `const Decoder&`; all its state is local), with
the GIL released by ctypes for the length of each call.
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..container.basis import read_header, read_slice_descs
from ..container.etc1s_frontend import _NativeModels
from ..container.writer import write_etc1s_basis_fuzz


def slice_file(nbx: int, nby: int, e: int = 512, s: int = 384, hist: int = 32, seed: int = 9):
    """(file bytes, expected endpoint indices, expected selector indices) of
    a one-slice ETC1S file of nbx x nby blocks over seeded random codebooks
    of e endpoints and s selectors, drawn as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    return write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, hist, seed=seed)


def make_slice(nbx: int, nby: int, e: int = 512, s: int = 384, hist: int = 32, seed: int = 9):
    """(decoder handle, slice payload, expected endpoint indices, expected
    selector indices) of slice_file()'s file."""
    buf, exp_ep, exp_sel = slice_file(nbx, nby, e, s, hist, seed)
    h = read_header(buf)
    desc = read_slice_descs(buf, h)[0]
    models = _NativeModels(buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
                           h.total_endpoints, h.total_selectors, False)
    return models, desc.data(buf), exp_ep, exp_sel


def decode_slice(models, nbx: int, nby: int, data):
    """One slice through the C++ front-end: (endpoint, selector) uint16 [nbx * nby]."""
    ep = np.empty(nbx * nby, np.uint16)
    sel = np.empty(nbx * nby, np.uint16)
    models.decode_slice(nbx, nby, data, ep, sel)
    return ep, sel


def single_core_rate(n_blocks: int, reps: int = 5) -> float:
    """Blocks/s of one thread decoding one slice of n_blocks (1024 blocks a
    row), best of `reps`, after a decode checked against the written
    streams."""
    nbx = 1024
    nby = max(1, n_blocks // nbx)
    models, data, exp_ep, exp_sel = make_slice(nbx, nby)
    ep, sel = decode_slice(models, nbx, nby, data)
    if not (np.array_equal(ep, exp_ep) and np.array_equal(sel, exp_sel)):
        raise RuntimeError("the front-end's index streams differ from the ones written")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_slice(models, nbx, nby, data)
        best = min(best, time.perf_counter() - t0)
    return nbx * nby / best


def aggregate_rate(workers: int, n_blocks: int = 1 << 18, tasks_per_worker: int = 4, reps: int = 3) -> float:
    """Aggregate blocks/s of `workers` threads decoding slices of n_blocks
    concurrently on one shared decoder handle, best of `reps` over the
    timed region (one pass on a shared host is mostly scheduling noise).
    Every decode of the timed passes is checked against the written
    streams."""
    nbx = 512
    nby = max(1, n_blocks // nbx)
    n = nbx * nby
    models, data, exp_ep, exp_sel = make_slice(nbx, nby)
    n_tasks = workers * tasks_per_worker

    def task(_):
        return decode_slice(models, nbx, nby, data)

    best = float("inf")
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(task, range(workers)))  # start every thread
        for _ in range(reps):
            t0 = time.perf_counter()
            results = list(pool.map(task, range(n_tasks)))
            best = min(best, time.perf_counter() - t0)
            if not all(np.array_equal(ep, exp_ep) and np.array_equal(sel, exp_sel) for ep, sel in results):
                raise RuntimeError("a threaded decode differs from the written index streams")
    return n_tasks * n / best


def scaling_curve(max_workers: int, n_blocks: int = 1 << 18) -> list:
    """[(workers, aggregate blocks/s)] for 1, 2, 4, ... up to max_workers."""
    points = []
    w = 1
    while w <= max_workers:
        points.append((w, aggregate_rate(w, n_blocks)))
        w *= 2
    if points[-1][0] != max_workers:
        points.append((max_workers, aggregate_rate(max_workers, n_blocks)))
    return points


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Throughput of the C++ ETC1S front-end (module docstring).")
    ap.add_argument("--blocks", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--workers", type=int, default=0,
                    help="also measure the aggregate scaling curve up to N threads (0 = skip; e.g. the core count)")
    args = ap.parse_args(argv)

    rate = single_core_rate(args.blocks, args.reps)
    n = 1024 * max(1, args.blocks // 1024)
    print(f"{n} blocks, best of {args.reps}: {rate / 1e6:.1f} Mblk/s/core")
    if args.workers:
        base = None
        for w, r in scaling_curve(args.workers, min(args.blocks, 1 << 18)):
            base = base or r
            print(f"  {w:3d} worker(s): {r / 1e6:7.1f} Mblk/s aggregate ({r / base / w * 100:5.1f}% of linear)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
