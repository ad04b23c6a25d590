"""Throughput benchmark of the port on one CUDA card: the UASTC->BC7
aggregate and the rest of the JAX system's throughput table.

    python -m basisu_rs_tpu_torch.bench

Counterpart of the JAX system's `bench.py` (and of the host tool it
imports, ported as `tools/bench_etc1s_host.py`).  Prints ONE JSON line on
stdout with the keys of bench.py's line (`LINE_KEYS`) but `vs_baseline`,
which divides by a TPU target, plus `device`: the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them, and the CUDA device count.  Per-mode rates and the corpus stage
tables go to stderr.  With no CUDA card it prints the line with "value":
null and an "error", and exits 1: it never measures on the CPU.

Environment, as bench.py reads it: BENCH_N blocks (default 2^23);
BENCH_FAST=1 measures only the BC7 aggregate; BENCH_ALL=1 adds the file
pipeline (`BasisCorpusPipeline`, stderr only).

What each number includes:
- Per target (BC7, the headline, then RGBA, ASTC, ETC1, ETC2): the golden
  all-mode mix tiled to N blocks, each present mode's blocks gathered
  contiguous on the card, one unindexed launch of that mode's kernel
  (`ops/kernels.py` `mode_kernel`).  Device time from CUDA events on a
  preloaded stream, median of REPS.  The launches of a rep go in sequence
  with an event between each two (`utils/profiling.event_sequence_ms`): at
  2^23 blocks a mode's group (~441,500 blocks, ~14.6 MB in and out) fits in
  the 50 MB L2, and timing it alone over and over would time a warm cache,
  which the main path never gives it; in sequence the other modes' 250+ MB
  go through the L2 in between.  Each rep writes its own output buffers, and every one
  is checked against the tiled golden outputs.  The aggregate is blocks x
  16 texels / the sum of the per-mode medians, as in bench.py.
- ETC1S (rgba K6, rgba_alpha K8, etc1 K9): bench.py's seeded draws, E = S =
  2048, 2^21 blocks, codebooks packed once, one launch a kind
  (`check_index=False`), the three kinds in sequence a rep as above; every
  output equal to the kind's plain version run on the card.
- Sharded (`parallel/mesh.py` on `make_mesh()`, every card): timed as
  called, CUDA events with no preload, since both calls wait on the host.
  `sharded_mode_step` ends in a host read of its error count;
  `sharded_etc1s_transcode` packs the codebooks and copies them to every
  card on each call.  Their times include that host work.
- Host front-end: host clock, best of 5 (one core) or 3 (all cores).
- Corpus, device-resident: host clock around parse, enqueue and one sync
  (SYNC), and the marginal cost of a corpus when R corpora share one sync
  (PIPELINED), as bench.py computes them; outputs folded into device
  checksums that must equal the expected ones.

No number this prints was taken on or for a TPU.  Importing this module
runs nothing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

from .container import basis as basis_mod
from .container.writer import write_etc1s_basis, write_uastc_basis
from .models.pipeline import BasisCorpusPipeline
from .models.transcoder import Etc1sFileWork, Etc1sMultiCorpusTranscoder, UastcTranscoder
from .ops import etc1s, kernels
from .ops.dispatch import partition
from .parallel.mesh import make_mesh, mesh_devices, sharded_etc1s_transcode, sharded_mode_step
from .tables import INVALID_MODE
from .tools import bench_etc1s_host
from .utils.profiling import event_sequence_ms

METRIC = "UASTC->BC7 aggregate transcode throughput (device-resident, all-mode corpus mix)"
UNIT = "Mtexels/s"
FIXTURE = Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "golden_blocks.npz"
N_BLOCKS = 1 << 23  # BENCH_N's default (bench.py:48)
REPS = 10
TEXELS = 16  # a block's texels
OTHER_TARGETS = ("rgba", "astc", "etc1", "etc2")  # bench.py:716's order
ETC1S_N, ETC1S_BOOK = 1 << 21, 2048  # bench.py:183
HOST_BLOCKS = 1 << 18  # bench.py:302
CORPUS = (8, 128, 128)  # files of each format, blocks a row, rows (bench.py:423)
PIPELINE_CORPUS = (8, 64, 64)  # bench.py:322
CORPUS_SEED = 17
R_LO, R_HI = 2, 10  # corpora a sync in the pipelined runs (bench.py:592)

# The keys of bench.py's line (bench.py:776-782 and the extras of :714-768)
# but vs_baseline; "etc1s_host_degenerate" joins them on a one-core host.
LINE_KEYS = (
    "metric", "value", "unit",
    "rgba_mtexels_s", "astc_mtexels_s", "etc1_mtexels_s", "etc2_mtexels_s",
    "etc1s_rgba_mtexels_s", "etc1s_rgba_alpha_mtexels_s", "etc1s_etc1_mtexels_s",
    "etc1s_host_mblocks_s_core", "etc1s_host_mblocks_s_total", "etc1s_host_workers",
    "sharded_bc7_mtexels_s", "sharded_pct_of_plain", "sharded_etc1s_rgba_mtexels_s",
    "corpus_device_sync_rtt_ms", "corpus_device_launch_overhead_ms",
    "corpus_device_uastc_bc7_mtexels_s", "corpus_device_uastc_bc7_pipelined_mtexels_s",
    "corpus_device_etc1s_rgba_mtexels_s", "corpus_device_etc1s_rgba_pipelined_mtexels_s",
)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_batch(n_blocks: int) -> np.ndarray:
    """The golden all-mode mix (`bc7_in`) tiled to n_blocks (bench.py:55)."""
    return tile(np.load(FIXTURE)["bc7_in"], n_blocks)


def tile(rows: np.ndarray, n: int) -> np.ndarray:
    return np.tile(rows, (-(-n // len(rows)),) + (1,) * (rows.ndim - 1))[:n]


def golden_outputs(target: str, n_blocks: int) -> np.ndarray:
    """The golden `{target}_out` rows as uint8 block rows, tiled as
    build_batch tiles the inputs (every target's golden inputs are
    `bc7_in`)."""
    g = np.load(FIXTURE)
    require(np.array_equal(g[f"{target}_in"], g["bc7_in"]), f"golden {target} inputs differ from bc7's")
    out = g[f"{target}_out"]
    return tile(out.view(np.uint8).reshape(len(out), kernels.OUT_BYTES[target]), n_blocks)


def medians_s(times_ms: list) -> list:
    return [statistics.median(t) * 1e-3 for t in times_ms]


def check_calls(counts: dict, plain: dict, device, expected: dict, what: str) -> None:
    """The wrappers' counters after a timed run: on the card the expected
    launches of each key (0 where expected names none) and no plain-version
    call; on the CPU (the tests) the same numbers of plain-version calls and
    no launch."""
    used, unused = (counts, plain) if torch.device(device).type == "cuda" else (plain, counts)
    for key, n in used.items():
        require(n == expected.get(key, 0), f"{what}: {n} calls of {key}, expected {expected.get(key, 0)}")
    require(all(v == 0 for v in unused.values()), f"{what}: calls on the other side of the wrapper: {unused}")


def flat_counts(counts: dict) -> dict:
    """{target: [per mode]} -> {(target, mode): n}"""
    return {(t, m): n for t, ns in counts.items() for m, n in enumerate(ns)}


def present_modes(counts: list) -> list:
    """[(mode, first, end)] of the valid modes present, rows of the mode-sorted batch."""
    ends = np.cumsum(counts).tolist()
    return [(m, e - c, e) for m, (c, e) in enumerate(zip(counts, ends)) if c and m != INVALID_MODE]


def bench_target(target: str, blocks: np.ndarray, device="cuda", reps: int = REPS, timer=None) -> float:
    """Aggregate texels/s of `target` over the modes of `blocks` (bench.py:105):
    one unindexed launch a mode over its contiguous blocks, device time; each
    rep's outputs checked against the tiled golden outputs.  stderr also
    gets the time of the same launches with no event between them."""
    timer = timer or partial(event_sequence_ms, preload=True)
    x = torch.from_numpy(np.ascontiguousarray(blocks)).to(device)
    ((order, counts),) = partition([x])
    x = x[order]  # grouped by mode, contiguous
    expect = torch.from_numpy(golden_outputs(target, len(blocks))).to(device)[order]
    groups = present_modes(counts)
    n_valid = groups[-1][2] if groups else 0
    outs = [torch.empty(len(blocks), kernels.OUT_BYTES[target], dtype=torch.uint8, device=device) for _ in range(reps)]
    errs = [torch.empty(len(blocks), dtype=torch.bool, device=device) for _ in range(reps)]

    def launch(m, a, b):
        k = kernels.mode_kernel(target, m)
        return lambda r: k(x[a:b], None, outs[r][a:b], errs[r][a:b])

    def timed(seq) -> list:
        """Median seconds of each call of seq, every rep's outputs checked
        (cleared first, so a launch that wrote nothing fails)."""
        for o, e in zip(outs, errs):
            o.zero_()
            e.fill_(True)
        kernels.reset_counts()
        per = medians_s(timer(seq, reps))
        sync(device)
        for r in range(reps):
            require(bool(torch.equal(outs[r][:n_valid], expect[:n_valid])) and not bool(errs[r][:n_valid].any()),
                    f"{target}: rep {r}'s output differs from the tiled golden outputs")
        check_calls(flat_counts(kernels.launch_counts()), flat_counts(kernels.plain_call_counts()), device,
                    {(target, m): reps for m, _, _ in groups}, target)
        return per

    fns = [launch(m, a, b) for m, a, b in groups]
    for fn in fns:
        fn(0)  # warm-up
    per = timed(fns)
    # the same launches with no event between them: what the events cost
    whole = timed([lambda r: [fn(r) for fn in fns]])[0]
    for (m, a, b), s in zip(groups, per):
        log(f"  {target} mode {m:2d}: {(b - a) / s / 1e6:7.1f} Mblocks/s")
    log(f"  {target}: {len(groups)} launches a rep, device time summed {sum(per) * 1e3:.4f} ms over {n_valid} blocks; "
        f"the same launches with no event between them {whole * 1e3:.4f} ms")
    return n_valid * TEXELS / sum(per)


def etc1s_draws(rng, n: int, e: int, s: int, pairs: int):
    """bench.py's ETC1S draws (:198-212): codebooks, then `pairs` (endpoint,
    selector) index streams of n blocks."""
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    streams = []
    for _ in range(pairs):
        streams += [rng.integers(0, e, n).astype(np.int32), rng.integers(0, s, n).astype(np.int32)]
    return endpoints, selectors, streams


def etc1s_plain(kind: str, endpoints, selectors, ep_idx, sel_idx, device) -> torch.Tensor:
    """The plain version of an ETC1S kind over one codebook pair, on `device`."""
    words = etc1s.selector_wire_words(selectors) if kind == "etc1" else etc1s.pack_selectors(selectors)
    out = torch.empty(len(ep_idx), etc1s.OUT_BYTES[kind], dtype=torch.uint8, device=device)
    etc1s.PLAIN[kind](etc1s.codebook_tensor(etc1s.pack_endpoints(endpoints), device),
                      etc1s.codebook_tensor(words, device),
                      [etc1s.index_tensor(ep_idx, device), etc1s.index_tensor(sel_idx, device)], out)
    return out


def bench_etc1s(device="cuda", n: int = ETC1S_N, e: int = ETC1S_BOOK, s: int = ETC1S_BOOK, reps: int = REPS,
                timer=None) -> dict:
    """{kind: texels/s} of K6 (rgba), K8 (rgba_alpha) and K9 (etc1) over one
    launch of n blocks each (bench.py:183); every rep's output equal to the
    kind's plain version on the same inputs."""
    timer = timer or partial(event_sequence_ms, preload=True)
    endpoints, selectors, streams = etc1s_draws(np.random.default_rng(5), n, e, s, 2)
    ep_tab = etc1s.codebook_tensor(etc1s.pack_endpoints(endpoints), device)
    sel_tab = etc1s.codebook_tensor(etc1s.pack_selectors(selectors), device)
    wire_tab = etc1s.codebook_tensor(etc1s.selector_wire_words(selectors), device)
    idx = [etc1s.index_tensor(a, device) for a in streams]
    runs = {"rgba": (sel_tab, idx[:2]), "rgba_alpha": (sel_tab, idx), "etc1": (wire_tab, idx[:2])}
    outs, fns = {}, []
    for kind, (tab, kidx) in runs.items():
        outs[kind] = [torch.empty(n, etc1s.OUT_BYTES[kind], dtype=torch.uint8, device=device) for _ in range(reps)]
        k = etc1s.etc1s_kernel(kind)
        fns.append(lambda r, k=k, tab=tab, kidx=kidx, o=outs[kind]: k(ep_tab, tab, *kidx, out=o[r], check_index=False))
    for fn in fns:
        fn(0)  # warm-up
    for o in (o for kind_outs in outs.values() for o in kind_outs):
        o.zero_()  # no kind's output row is all zero: a launch that wrote nothing fails the check
    etc1s.reset_counts()
    per = medians_s(timer(fns, reps))
    sync(device)
    for kind, (tab, kidx) in runs.items():
        ref = torch.empty_like(outs[kind][0])
        etc1s.PLAIN[kind](ep_tab, tab, kidx, ref)
        for r, o in enumerate(outs[kind]):
            require(bool(torch.equal(o, ref)), f"ETC1S {kind}: rep {r}'s output differs from the plain version")
    check_calls(etc1s.launch_counts(), etc1s.plain_call_counts(), device, {kind: reps for kind in runs}, "ETC1S")
    return {kind: n * TEXELS / t for kind, t in zip(runs, per)}


def sharded_launches(n: int, shards: int) -> int:
    """Launches of one sharded call over n blocks: one a non-empty shard
    (parallel/mesh.py splits into shards of ceil(n / shards) rows)."""
    return -(-n // -(-n // shards)) if n else 0


def bench_target_sharded(target: str, blocks: np.ndarray, mesh=None, reps: int = REPS, timer=None) -> float:
    """Aggregate texels/s of `target` through `sharded_mode_step` on every
    card (bench.py:161), one step a mode over its contiguous blocks on
    mesh[0], timed as called; each call's output and error count checked."""
    timer = timer or event_sequence_ms
    mesh = mesh_devices(mesh or make_mesh())
    x = torch.from_numpy(np.ascontiguousarray(blocks)).to(mesh[0])
    ((order, counts),) = partition([x])
    x = x[order]
    expect = torch.from_numpy(golden_outputs(target, len(blocks))).to(mesh[0])[order]
    groups = present_modes(counts)
    results = [[None] * len(groups) for _ in range(reps)]

    def step_fn(k, m, a, b):
        step = sharded_mode_step(target, m, mesh)

        def fn(r):
            results[r][k] = step(x[a:b])

        return fn

    fns = [step_fn(k, m, a, b) for k, (m, a, b) in enumerate(groups)]
    for fn in fns:
        fn(0)  # warm-up
    kernels.reset_counts()
    per = medians_s(timer(fns, reps))
    for r in range(reps):
        for (m, a, b), (out, err, n_err) in zip(groups, results[r]):
            require(n_err == 0 and bool(torch.equal(out, expect[a:b])) and not bool(err.any()),
                    f"sharded {target} mode {m}: rep {r}'s output differs from the tiled golden outputs")
    check_calls(flat_counts(kernels.launch_counts()), flat_counts(kernels.plain_call_counts()), mesh[0],
                {(target, m): reps * sharded_launches(b - a, len(mesh)) for m, a, b in groups}, f"sharded {target}")
    for (m, a, b), s in zip(groups, per):
        log(f"  sharded {target} mode {m:2d}: {(b - a) / s / 1e6:7.1f} Mblocks/s")
    return sum(b - a for _, a, b in groups) * TEXELS / sum(per)


def bench_etc1s_sharded(mesh=None, n: int = ETC1S_N, e: int = ETC1S_BOOK, s: int = ETC1S_BOOK, reps: int = REPS,
                        timer=None) -> float:
    """Texels/s of ETC1S -> RGBA through `sharded_etc1s_transcode` on every
    card (bench.py:244): index streams resident on mesh[0], the codebooks
    packed and copied by each call, timed as called; each call's output
    equal to K6's plain version."""
    timer = timer or event_sequence_ms
    mesh = mesh_devices(mesh or make_mesh())
    endpoints, selectors, streams = etc1s_draws(np.random.default_rng(5), n, e, s, 1)
    ep, sel = (etc1s.index_tensor(a, mesh[0]) for a in streams)
    outs = [None] * reps

    def fn(r):
        outs[r] = sharded_etc1s_transcode("rgba", endpoints, selectors, ep, sel, mesh, check_index=False)

    fn(0)  # warm-up
    etc1s.reset_counts()
    per = medians_s(timer([fn], reps))[0]
    ref = etc1s_plain("rgba", endpoints, selectors, ep, sel, mesh[0])
    for r, o in enumerate(outs):
        require(bool(torch.equal(o.view(torch.uint8), ref)), f"sharded ETC1S rgba: rep {r}'s output differs from "
                                                             "the plain version")
    check_calls(etc1s.launch_counts(), etc1s.plain_call_counts(), mesh[0],
                {"rgba": reps * sharded_launches(n, len(mesh))}, "sharded ETC1S")
    return n * TEXELS / per


def host_frontend(workers: int, n_blocks: int = HOST_BLOCKS) -> dict:
    """The host front-end's keys of the line (bench.py:723-749): one core's
    rate, and the aggregate of `workers` threads (the core count), or on a
    one-core host that same rate flagged degenerate."""
    hr = bench_etc1s_host.single_core_rate(n_blocks)
    log(f"ETC1S host front-end: {hr / 1e6:.1f} Mblocks/s/core")
    rates = {"etc1s_host_mblocks_s_core": hr / 1e6}
    if workers == 1:
        total = hr
        rates["etc1s_host_degenerate"] = True
        log("ETC1S host front-end aggregate: 1 core - reporting the per-core rate (degenerate; no scaling axis)")
    else:
        total = bench_etc1s_host.aggregate_rate(workers, n_blocks)
        log(f"ETC1S host front-end aggregate ({workers} worker(s) = machine core count): "
            f"{total / 1e6:.1f} Mblocks/s total")
    rates["etc1s_host_mblocks_s_total"] = total / 1e6
    rates["etc1s_host_workers"] = workers
    return rates


def sync_rtt_s(device, samples: int = 6) -> float:
    """Host time to read back one fresh device scalar: the floor of every
    synchronous result."""
    for i in range(2):
        int(torch.tensor(i, device=device) + 1)
    ts = []
    for i in range(samples):
        t0 = time.perf_counter()
        int(torch.tensor(i, device=device) + 1)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def launch_overhead_s(device, samples: int = 3, n: int = 24) -> float:
    """Marginal host cost of one more launch of a trivial op: a chain of n
    adds with one final synchronize, minus the one-add run, per extra add."""
    x = torch.zeros((8, 128), dtype=torch.int32, device=device)

    def run(k):
        t0 = time.perf_counter()
        y = x
        for _ in range(k):
            y = y + 1
        sync(device)
        return time.perf_counter() - t0

    run(n)  # warm-up
    return min(max((run(n) - run(1)) / (n - 1), 1e-9) for _ in range(samples))


def corpus_files(tmp: Path, n_files: int, nbx: int, nby: int):
    """bench.py's corpus (:336-362): n_files UASTC files of the golden mix
    and n_files ETC1S files over one seeded codebook pair (E = 128, S = 96),
    nbx x nby blocks each, written by the port's writers.  Returns (UASTC
    paths, ETC1S paths, golden blocks, codebooks, each ETC1S file's
    (endpoint, selector) streams)."""
    rng = np.random.default_rng(CORPUS_SEED)
    blocks = build_batch(nbx * nby)
    e, s = 128, 96
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    geometry = dict(nbx=nbx, nby=nby, orig_width=nbx * 4, orig_height=nby * 4)
    uastc, etc, streams = [], [], []
    for i in range(n_files):
        p = tmp / f"u{i}.basis"
        p.write_bytes(write_uastc_basis([dict(blocks=blocks, **geometry)]))
        uastc.append(p)
        ep_idx, sel_idx = rng.integers(0, e, nbx * nby), rng.integers(0, s, nbx * nby)
        p = tmp / f"e{i}.basis"
        p.write_bytes(write_etc1s_basis(endpoints, selectors, [dict(ep_idx=ep_idx, sel_idx=sel_idx, **geometry)]))
        etc.append(p)
        streams.append((ep_idx, sel_idx))
    return uastc, etc, (endpoints, selectors), streams


def fold(t: torch.Tensor) -> torch.Tensor:
    """A device output's byte sum, an int64 scalar on its device."""
    return t.contiguous().view(torch.uint8).sum(dtype=torch.int64)


def bench_corpus_device(device="cuda", kernel_rates: dict | None = None, n_files: int = CORPUS[0],
                        nbx: int = CORPUS[1], nby: int = CORPUS[2]) -> dict:
    """Corpus rates with outputs kept on the card (bench.py:423): host parse
    and CRC (and the C++ front-end for ETC1S) -> launches -> outputs folded
    into device checksums; only the checksums come back.

    SYNC: parse, enqueue and one sync of one corpus (best of 3 a stage).
    PIPELINED: R corpora (fresh parse and launches each) under one sync,
    the marginal time of a corpus (T(R_HI) - T(R_LO)) / (R_HI - R_LO).
    Each corpus's checksums must equal the expected ones (the golden BC7
    outputs; K6's plain version over the written index streams), and every
    output of the first run equal to them exactly.  kernel_rates: {key:
    texels/s} of this run's kernel benches, for the stage table's device
    share."""
    kernel_rates = kernel_rates or {}
    rates = {"sync_rtt_ms": sync_rtt_s(device) * 1e3}
    log(f"corpus-device sync RTT floor: {rates['sync_rtt_ms']:.3f} ms")
    lo_ms = launch_overhead_s(device) * 1e3
    rates["launch_overhead_ms"] = lo_ms
    log(f"corpus-device per-launch overhead: {lo_ms:.4f} ms/launch (x19 mode launches/corpus on the UASTC path)")

    with tempfile.TemporaryDirectory() as td:
        uastc_paths, etc1s_paths, (endpoints, selectors), streams = corpus_files(Path(td), n_files, nbx, nby)
        bc7_golden = torch.from_numpy(golden_outputs("bc7", nbx * nby)).to(device)
        etc1s_expect = [etc1s_plain("rgba", endpoints, selectors, ep, sel, device) for ep, sel in streams]
        tr = UastcTranscoder("bc7", device)
        etc1s_tr = Etc1sMultiCorpusTranscoder("rgba", device)

        def parse_uastc(paths):
            batches = []
            for p in paths:
                buf = p.read_bytes()
                h = basis_mod.read_header(buf)
                require(basis_mod.check_file_checksum(buf, h), f"{p.name}: data CRC16 failed")
                blocks, _ = basis_mod.uastc_host_payload(buf, basis_mod.read_slice_descs(buf, h))
                batches.append(blocks.numpy())
            return np.concatenate(batches, axis=0)

        def dispatch_uastc(batch, check=False):
            # one dispatch over every file's blocks (the corpus layer's
            # cross-file batch): one launch a corpus for BC7
            res = tr.transcode_async(batch)
            if check:
                require(bool(torch.equal(res.out, bc7_golden.repeat(n_files, 1))) and not bool(res.err.any()),
                        "corpus UASTC->BC7 output differs from the golden outputs")
            return torch.stack([fold(res.out), res.err.sum()]), batch.shape[0] * TEXELS

        def parse_etc1s(paths):
            works = []
            for p in paths:
                buf = p.read_bytes()
                h = basis_mod.read_header(buf)
                require(basis_mod.check_file_checksum(buf, h), f"{p.name}: data CRC16 failed")
                dec = basis_mod.make_etc1s_decoder(h, buf)
                slices = []
                for d in basis_mod.read_slice_descs(buf, h):
                    sl = dec.decode_slice(d.num_blocks_x, d.num_blocks_y, d.data(buf))
                    slices.append((sl.endpoint_index, sl.selector_index))
                works.append(Etc1sFileWork(dec.endpoints, dec.selectors, slices))
            return works

        def dispatch_etc1s(works, check=False):
            # the cross-file batcher: codebooks concatenate, index streams
            # rebase, one K6 launch for the corpus
            outs = etc1s_tr.transcode_files(works, resident=True)
            flat = [o for per_file in outs for o in per_file]
            if check:
                require(len(flat) == n_files and all(bool(torch.equal(o.view(torch.uint8), x))
                                                     for o, x in zip(flat, etc1s_expect)),
                        "corpus ETC1S->RGBA output differs from the plain version")
            acc = torch.stack([sum(fold(o) for o in flat), torch.zeros((), dtype=torch.int64, device=device)])
            return acc, sum(o.shape[0] for o in flat) * TEXELS

        expected = {
            "uastc_bc7": [int(fold(bc7_golden)) * n_files, 0],
            "etc1s_rgba": [sum(int(fold(x)) for x in etc1s_expect), 0],
        }
        for label, key, parse, dispatch, paths in (
            ("UASTC->BC7", "uastc_bc7", parse_uastc, dispatch_uastc, uastc_paths),
            ("ETC1S->RGBA", "etc1s_rgba", parse_etc1s, dispatch_etc1s, etc1s_paths),
        ):
            acc, _ = dispatch(parse(paths), check=True)  # warm-up, every output checked
            require(acc.tolist() == expected[key], f"corpus {label}: checksum {acc.tolist()} != {expected[key]}")

            st_parse = st_disp = st_sync = float("inf")
            texels = 0
            for _ in range(3):
                t0 = time.perf_counter()
                work = parse(paths)
                t1 = time.perf_counter()
                acc, texels = dispatch(work)
                t2 = time.perf_counter()
                got = acc.tolist()
                t3 = time.perf_counter()
                require(got == expected[key], f"corpus {label}: checksum {got} != {expected[key]}")
                st_parse, st_disp, st_sync = min(st_parse, t1 - t0), min(st_disp, t2 - t1), min(st_sync, t3 - t2)
            total = st_parse + st_disp + st_sync
            rates[key] = texels / total
            dev = (f"device compute ~{texels / kernel_rates[key] * 1e3:.4f} ms at this run's kernel rate"
                   if key in kernel_rates else "device compute not measured in this run")
            log(f"corpus-device {label} stage table ({texels / 1e6:.2f} Mtex): parse {st_parse * 1e3:.3f} ms, "
                f"dispatch-enqueue {st_disp * 1e3:.3f} ms, sync-wait {st_sync * 1e3:.3f} ms (RTT floor "
                f"{rates['sync_rtt_ms']:.3f} ms), {dev}")
            log(f"corpus-device {label} SYNC: {texels / total / 1e6:8.1f} Mtex/s (one-shot latency incl. sync)")

            def run_r(r, parse=parse, dispatch=dispatch, key=key, label=label):
                t0 = time.perf_counter()
                total_acc = torch.zeros(2, dtype=torch.int64, device=device)
                for _ in range(r):
                    acc, _ = dispatch(parse(paths))
                    total_acc += acc
                got = total_acc.tolist()
                dt = time.perf_counter() - t0
                require(got == [r * v for v in expected[key]], f"corpus {label}: {r} corpora's checksum {got}")
                return dt

            run_r(R_LO)  # warm-up
            t_lo = min(run_r(R_LO) for _ in range(2))
            t_hi = min(run_r(R_HI) for _ in range(2))
            marginal = max((t_hi - t_lo) / (R_HI - R_LO), 1e-9)
            rates[key + "_pipelined"] = texels / marginal
            log(f"corpus-device {label} PIPELINED: {texels / marginal / 1e6:8.1f} Mtex/s steady-state (marginal "
                f"per-corpus {marginal * 1e3:.3f} ms; host parse+enqueue bound - see stage table)")
    return rates


def bench_corpus(device="cuda", n_files: int = PIPELINE_CORPUS[0], nbx: int = PIPELINE_CORPUS[1],
                 nby: int = PIPELINE_CORPUS[2]) -> None:
    """The file pipeline (`BasisCorpusPipeline`, bench.py:322) over bench.py's
    corpus on disk: files/s and texels/s on the host clock, then the
    pipeline's stage table, on stderr.  Every image is checked: UASTC->BC7
    against the golden outputs, ETC1S->ETC1 against K9's plain version."""
    with tempfile.TemporaryDirectory() as td:
        uastc_paths, etc1s_paths, (endpoints, selectors), streams = corpus_files(Path(td), n_files, nbx, nby)
        bc7 = torch.from_numpy(golden_outputs("bc7", nbx * nby)).to(device)
        etc1 = [etc1s_plain("etc1", endpoints, selectors, ep, sel, device) for ep, sel in streams]
        for label, target, paths, expect in (
            ("UASTC->BC7", "bc7", uastc_paths, [bc7] * n_files),
            ("ETC1S->ETC1", "etc1", etc1s_paths, etc1),
        ):
            pipe = BasisCorpusPipeline(target, workers=min(8, os.cpu_count() or 1), device=device)
            list(pipe.run(paths))  # warm-up: page cache, libraries
            pipe.profiler.stats.clear()
            t0 = time.perf_counter()
            results = list(pipe.run(paths))
            sync(device)
            dt = time.perf_counter() - t0
            require(not pipe.errors, f"pipeline {label}: {pipe.errors}")
            require(len(results) == n_files and all(
                len(r.images) == 1 and bool(torch.equal(r.images[0].data.reshape(x.shape), x))
                for r, x in zip(results, expect)), f"pipeline {label}: an image differs from the expected output")
            texels = sum(r.texels for r in results)
            log(f"corpus {label}: {len(results) / dt:6.1f} files/s, {texels / dt / 1e6:8.1f} Mtex/s end-to-end")
            for line in pipe.profiler.report().splitlines():
                log(f"    {line}")


def measure(device, n_blocks: int, fast: bool = False, bench_all: bool = False, reps: int = REPS, timer=None,
            mesh=None) -> tuple:
    """(BC7 aggregate texels/s, the line's other keys): bench.py's main
    (:703-771) on `device`.  timer replaces the CUDA-event timers (tests
    run the plain versions on the CPU with one); mesh replaces make_mesh()."""
    blocks = build_batch(n_blocks)
    rate = bench_target("bc7", blocks, device, reps, timer)
    log(f"UASTC->BC7 aggregate: {rate / 1e9:.2f} Gtexels/s")
    extra = {}
    if fast:
        return rate, extra
    for target in OTHER_TARGETS:
        r = bench_target(target, blocks, device, reps, timer)
        log(f"UASTC->{target.upper()} aggregate: {r / 1e9:.2f} Gtexels/s")
        extra[f"{target}_mtexels_s"] = r / 1e6
    etc1s_rates = bench_etc1s(device, ETC1S_N, reps=reps, timer=timer)
    for kind, r in etc1s_rates.items():
        log(f"ETC1S->{kind.upper()}: {r / 1e9:.2f} Gtexels/s")
        extra[f"etc1s_{kind}_mtexels_s"] = r / 1e6
    extra.update(host_frontend(os.cpu_count() or 1, HOST_BLOCKS))
    mesh = mesh_devices(mesh or make_mesh())
    srate = bench_target_sharded("bc7", blocks, mesh, reps, timer)
    log(f"UASTC->BC7 aggregate (sharded per-mode step, {len(mesh)} device(s)): {srate / 1e9:.2f} Gtexels/s "
        f"({srate / rate * 100:.0f}% of plain path)")
    extra["sharded_bc7_mtexels_s"] = srate / 1e6
    extra["sharded_pct_of_plain"] = srate / rate * 100
    serate = bench_etc1s_sharded(mesh, ETC1S_N, reps=reps, timer=timer)
    log(f"ETC1S->RGBA (sharded, {len(mesh)} device(s)): {serate / 1e9:.2f} Gtexels/s")
    extra["sharded_etc1s_rgba_mtexels_s"] = serate / 1e6
    corpus = bench_corpus_device(device, {"uastc_bc7": rate, "etc1s_rgba": etc1s_rates["rgba"]}, *CORPUS)
    for key, r in corpus.items():
        if key.endswith("_ms"):
            extra[f"corpus_device_{key}"] = r
        else:
            extra[f"corpus_device_{key}_mtexels_s"] = r / 1e6
    if bench_all:
        bench_corpus(device, *PIPELINE_CORPUS)
    return rate, extra


def result_line(rate: float, extra: dict, device: dict) -> dict:
    """The JSON line: bench.py's keys but vs_baseline, plus `device`."""
    return {"metric": METRIC, "value": rate / 1e6, "unit": UNIT, **extra, "device": device}


def device_facts() -> dict:
    """{name, count, power_limit_w} of the card: name and power limit as
    nvidia-smi gives them, count from torch."""
    res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, power = (f.strip() for f in res.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "count": torch.cuda.device_count(), "power_limit_w": power}


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT,
                          "error": "no CUDA device: torch.cuda.is_available() is False, and this benchmark "
                                   "runs only on the card"}))
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    facts = device_facts()
    n_blocks = int(os.environ.get("BENCH_N", N_BLOCKS))
    log(f"devices: {facts['count']} x {facts['name']} ({facts['power_limit_w']}), N={n_blocks} blocks")
    rate, extra = measure(device, n_blocks, fast=bool(os.environ.get("BENCH_FAST")),
                          bench_all=bool(os.environ.get("BENCH_ALL")))
    print(json.dumps(result_line(rate, extra, facts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
