"""High-level corpus transcoders.

Port of `basisu_rs_tpu/models/transcoder.py`: the surface for corpus-scale
work, above the block dispatch (`ops/dispatch.py`) and the ETC1S entries
(`ops/etc1s.py`).  Each class runs on `device="cuda"` unless constructed
with another device, and raises without a card, as every entry of the port
does.  Profiler stages keep the JAX package's names but for the UASTC
copy to the device ("host/copy"; the partition, where a target has one,
runs inside "device/dispatch"); each is host wall time around work that
may still run on the card, and a span of the recorder
(utils/profiling.py): "device/dispatch" is the launches' enqueue.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..base import BasisError, block_tensor, resolve_device, to_device
from ..ops.dispatch import transcode_shards
from ..ops.etc1s import run_etc1s_etc1, run_etc1s_rgba
from ..ops.kernels import TARGETS
from ..utils.profiling import Profiler, count


def _split_rows(out, counts: list) -> list:
    """out's rows (host numpy or a torch tensor) as consecutive views of
    `counts` rows each."""
    if isinstance(out, torch.Tensor):
        return list(torch.split(out, counts))
    return np.split(out, np.cumsum(counts)[:-1])


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device result as host numpy, uint32 words kept as uint32 (from a
    card, a copy the host waits for: counted in `host_syncs`)."""
    if t.device.type != "cpu":
        count("host_syncs")
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


@dataclass
class TranscodeResult:
    """Device-side result of a batch transcode: the dispatch writes every
    mode's rows in place, so one `out` and one `err` on the device take the
    place of the JAX package's per-mode groups.  `gather()` copies them to
    the host in block order."""

    n: int
    target: str
    out: torch.Tensor
    err: torch.Tensor

    def gather(self):
        """(out, err) as numpy: uint8 [N, 16] for bc7, astc and etc2, uint8
        [N, 8] for etc1, uint32 [N, 16] packed RGBA texels for rgba; err
        bool [N]."""
        return to_host(self.out), to_host(self.err)


class UastcTranscoder:
    """Batch transcoder for UASTC blocks over one dense batch: BC7 in one
    launch, another target in one launch per present mode; per-stage
    timings in `.profiler`."""

    def __init__(self, target: str, device="cuda"):
        if target not in TARGETS:
            raise BasisError(f"unknown target {target!r}")
        self.target = target
        self.device = resolve_device(device)
        self.profiler = Profiler()

    def transcode_async(self, blocks_u8) -> TranscodeResult:
        """Copy the batch (numpy or torch uint8 [N, 16]) to the device and
        enqueue its launches (`transcode_shards`): on a card BC7 is one
        launch with no host read; another target is partitioned by mode
        first, whose 20 mode counts the host reads back, waiting for the
        copy and the partition.  The launches are not waited for."""
        n = int(np.prod(blocks_u8.shape)) // 16
        with self.profiler.stage("host/copy", texels=n * 16):
            blocks = to_device(block_tensor(blocks_u8), self.device)
        with self.profiler.stage("device/dispatch", texels=n * 16):
            out, err = transcode_shards([blocks], self.target, blocks.device)
        return TranscodeResult(n, self.target, out, err)

    def transcode(self, blocks_u8):
        """Synchronous host-to-host transcode: (out, err) numpy arrays."""
        res = self.transcode_async(blocks_u8)
        with self.profiler.stage("host/gather", texels=res.n * 16):
            return res.gather()


class CorpusTranscoder:
    """Multi-file / multi-slice (mipmapped) batch pipeline.

    Concatenates the blocks of many slices into one batch on the host, so
    small mip levels ride in the same launches as base levels (one for BC7,
    at most 19 for another target), then splits the results back per
    slice."""

    def __init__(self, target: str, device="cuda"):
        self.inner = UastcTranscoder(target, device)

    def transcode_slices(self, slices: list):
        """slices: list of uint8 [n_i, 16] block arrays.  Returns the list of
        per-slice outputs (numpy, dtypes as UastcTranscoder.transcode)."""
        counts = [np.asarray(s).reshape(-1, 16).shape[0] for s in slices]
        batch = np.concatenate([np.asarray(s).reshape(-1, 16) for s in slices], axis=0)
        out, err = self.inner.transcode(batch)
        if err.any():
            raise BasisError(f"{int(err.sum())} invalid blocks in corpus batch")
        return _split_rows(out, counts)

    @property
    def profiler(self) -> Profiler:
        return self.inner.profiler


@dataclass
class Etc1sFileWork:
    """One .basis file's decoded ETC1S state, ready for cross-file batching:
    its codebook pair plus per-slice index streams (and, for the RGBA
    target, the optional paired alpha-slice streams)."""

    endpoints: np.ndarray  # [E, 4] uint8
    selectors: np.ndarray  # [S, 4] uint8 packed selector rows
    slices: list  # [(ep_idx, sel_idx)] int arrays, one per slice
    alpha_slices: list | None = None  # parallel list for RGBA alpha pairing


def _batch_etc1s_files(files: list, with_alpha: bool):
    """Concatenate many files' codebooks + index streams into ONE gather
    space: file f's indices shift by its codebook base, so the palette
    gather cannot tell the batch from a single huge file.  Returns
    (endpoints, selectors, ep_idx, sel_idx, alpha_pair_or_None, counts)
    with counts = per-(file, slice) block counts in input order."""
    ep_books, sel_books = [], []
    ep_base = sel_base = 0
    eps, sels, a_eps, a_sels, counts = [], [], [], [], []
    for fw in files:
        e = np.asarray(fw.endpoints, np.uint8)
        s = np.asarray(fw.selectors, np.uint8)
        ep_books.append(e)
        sel_books.append(s)
        a_slices = fw.alpha_slices if with_alpha else [None] * len(fw.slices)
        if with_alpha and (fw.alpha_slices is None or len(fw.alpha_slices) != len(fw.slices)):
            raise BasisError("alpha_slices must pair 1:1 with slices")
        for (ep_i, sel_i), a in zip(fw.slices, a_slices):
            ep_i = np.asarray(ep_i, np.int32)
            sel_i = np.asarray(sel_i, np.int32)
            if with_alpha and (len(a[0]) != len(ep_i) or len(a[1]) != len(sel_i)):
                raise BasisError("RGB slice and Alpha slice have different dimensions")
            counts.append(len(ep_i))
            eps.append(ep_i + ep_base)
            sels.append(sel_i + sel_base)
            if with_alpha:
                a_eps.append(np.asarray(a[0], np.int32) + ep_base)
                a_sels.append(np.asarray(a[1], np.int32) + sel_base)
        ep_base += e.shape[0]
        sel_base += s.shape[0]
    endpoints = np.concatenate(ep_books, axis=0)
    selectors = np.concatenate(sel_books, axis=0)
    alpha = (np.concatenate(a_eps), np.concatenate(a_sels)) if with_alpha else None
    return endpoints, selectors, np.concatenate(eps), np.concatenate(sels), alpha, counts


# Per-launch bound on concatenated codebook entries (each table), from the
# port's index type, not from the JAX package's VMEM size: index streams
# travel to K6-K9 as uint16 (ops/etc1s.py index_tensor) and each file's
# indices shift by its codebook base, so a launch group's concatenated
# codebook may hold at most 65,536 entries, which keeps every shifted index
# <= 65,535.  At 4 B a packed entry that is 256 KiB a table, read through
# __ldg and far inside the H100's 50 MB L2.  A .basis codebook holds at most
# 65,535 entries (u16 header fields), so a lone file always fits; the split
# still lets a file larger than a smaller cap ride alone.  Outputs do not
# depend on the cap; only the launch count does.
MAX_BATCH_CODEBOOK_ENTRIES = 65536


def _split_by_codebook_budget(files: list, cap: int | None = None):
    """Greedily partition files into launch groups whose concatenated
    endpoint AND selector codebooks each stay within `cap` entries (default
    MAX_BATCH_CODEBOOK_ENTRIES, read at call time), keeping input order.
    A single file over the cap gets its own group."""
    if cap is None:
        cap = MAX_BATCH_CODEBOOK_ENTRIES
    groups, cur, e_sum, s_sum = [], [], 0, 0
    for fw in files:
        e = np.asarray(fw.endpoints).shape[0]
        s = np.asarray(fw.selectors).shape[0]
        if cur and (e_sum + e > cap or s_sum + s > cap):
            groups.append(cur)
            cur, e_sum, s_sum = [], 0, 0
        cur.append(fw)
        e_sum += e
        s_sum += s
    if cur:
        groups.append(cur)
    return groups


def _check_etc1s_target(target: str) -> None:
    if target not in ("rgba", "etc1"):
        raise BasisError(f"unsupported ETC1S corpus target {target!r}")


class Etc1sMultiCorpusTranscoder:
    """Cross-FILE ETC1S batching: slices from many .basis files, each with
    its own codebook pair, ride one launch per target (two for the RGBA
    target when the corpus mixes alpha-paired and RGB-only files, since
    alpha pairing selects the fused kernel K8), split further where the
    concatenated codebooks would pass MAX_BATCH_CODEBOOK_ENTRIES.
    Codebooks concatenate along the entry axis and every file's index
    streams shift by its codebook base."""

    def __init__(self, target: str = "rgba", device="cuda"):
        _check_etc1s_target(target)
        self.target = target
        self.device = resolve_device(device)
        self.profiler = Profiler()

    def transcode_files(self, files: list, resident: bool = False) -> list:
        """files: list of Etc1sFileWork.  Returns one list per file of
        per-slice outputs (uint32 [n_i, 16] packed RGBA or [n_i, 2] ETC1
        words), in input order.  resident=False (the JAX package's
        device=False) returns host numpy; resident=True keeps the outputs
        on the device as torch tensors (views of one launch's output)."""
        if not files:
            return []
        # A zero-slice file contributes nothing to any launch (and an
        # all-empty group would hit np.concatenate([]) in the batcher):
        # answer [] for it and batch only the files with work.
        work = [fw for fw in files if fw.slices]
        if not work:
            return [[] for _ in files]
        if self.target == "etc1":
            groups = [(work, False)]
        else:
            with_a = [fw for fw in work if fw.alpha_slices is not None]
            without_a = [fw for fw in work if fw.alpha_slices is None]
            groups = [(g, bool(a)) for g, a in ((with_a, True), (without_a, False)) if g]
        groups = [(sub, with_alpha) for g, with_alpha in groups for sub in _split_by_codebook_budget(g)]

        out_by_id = {}
        for group, with_alpha in groups:
            endpoints, selectors, ep, sel, alpha, counts = _batch_etc1s_files(group, with_alpha)
            n = sum(counts)
            with self.profiler.stage(f"device/etc1s_{self.target}", texels=n * 16):
                if self.target == "rgba":
                    out = run_etc1s_rgba(endpoints, selectors, ep, sel, alpha, device=self.device)
                else:
                    out = run_etc1s_etc1(endpoints, selectors, ep, sel, device=self.device)
                if not resident:
                    out = to_host(out)
            parts = iter(_split_rows(out, counts))
            for fw in group:
                out_by_id[id(fw)] = [next(parts) for _ in fw.slices]
        return [out_by_id[id(fw)] if fw.slices else [] for fw in files]


class Etc1sCorpusTranscoder:
    """ETC1S analog of CorpusTranscoder: many slices whose index streams
    share ONE codebook pair (a .basis file's endpoints/selectors) batch into
    a single launch per target, then split back per slice (the per-slice
    loops of the reference, basis.rs:26-86, batched)."""

    def __init__(self, endpoints: np.ndarray, selectors: np.ndarray, target: str = "rgba", device="cuda"):
        _check_etc1s_target(target)
        self.endpoints = np.asarray(endpoints, np.uint8)
        self.selectors = np.asarray(selectors, np.uint8)
        self.target = target
        self.device = resolve_device(device)
        self.profiler = Profiler()

    def transcode_slices(self, slices: list, alpha_slices: list | None = None):
        """slices: list of (ep_idx, sel_idx) int index arrays (one per slice);
        alpha_slices: optional parallel list for the RGBA target's paired
        alpha pass (same lengths as `slices`).  Returns a list of per-slice
        host outputs: uint32 [n_i, 16] packed RGBA texels, or uint32 [n_i, 2]
        ETC1 words."""
        counts = [len(ep) for ep, _ in slices]
        n = sum(counts)
        ep = np.concatenate([np.asarray(e) for e, _ in slices])
        sel = np.concatenate([np.asarray(s) for _, s in slices])
        with self.profiler.stage(f"device/etc1s_{self.target}", texels=n * 16):
            if self.target == "rgba":
                alpha_pass = None
                if alpha_slices is not None:
                    a_counts = [len(e) for e, _ in alpha_slices]
                    if a_counts != counts:
                        raise BasisError("RGB slice and Alpha slice have different dimensions")
                    alpha_pass = (
                        np.concatenate([np.asarray(e) for e, _ in alpha_slices]),
                        np.concatenate([np.asarray(s) for _, s in alpha_slices]),
                    )
                out = run_etc1s_rgba(self.endpoints, self.selectors, ep, sel, alpha_pass, device=self.device)
            else:
                out = run_etc1s_etc1(self.endpoints, self.selectors, ep, sel, device=self.device)
            out = to_host(out)
        return _split_rows(out, counts)
