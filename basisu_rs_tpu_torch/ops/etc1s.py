"""ETC1S back-end: codebook gather + per-block palette, K6-K9.

Port of `basisu_rs_tpu/ops/etc1s.py` and of the host packers of
`basisu_rs_tpu/ops/etc1s_pallas.py`, onto the port's ETC helpers
(`ops/etc.py`).  The host front-end (`container/etc1s_frontend.py`) emits
the endpoint codebook (uint8 [E, 4]: r5, g5, b5, inten3), the selector
codebook (uint8 [S, 4] row bytes) and per-block uint16 index streams.  The
packers turn each codebook into one 32-bit word an entry, stored as int32
tensors (torch has too few uint32 operators; the CUDA code reads the same
bits as uint32):
  endpoint word  r5 | g5 << 5 | b5 << 10 | inten << 15
  selector word  the four row bytes, row y at byte y (texel x at bits 2x)
  wire word      the ETC1 selector word of the entry (etc.rs:374-393)

The four kinds, one CUDA kernel each (`csrc/etc1s.cu`), mirroring the
per-block closures of the reference (src/basis_lz/mod.rs:97-186):
  "rgba"        K6: 16 packed RGBA texels a block, alpha 255
  "alpha"       K7: the palette's G of each texel (0-255 in a u32 word)
  "rgba_alpha"  K8: K6's RGB with the alpha byte taken from a second
                (alpha-slice) index pair: (rgba & 0x00FFFFFF) | alpha << 24
  "etc1"        K9: an 8-byte ETC1 block, the endpoint as a differential
                block with zero deltas and the wire word gathered as lane 1
Outputs are uint8 rows: [N, 64] for the texel kinds, [N, 8] for "etc1".

`etc1s_kernel(kind)` is the wrapper: a tensor on the CPU goes to the plain
version below (`PLAIN`), a CUDA tensor to the kernel, or the call raises.
Each wrapper counts its launches and its plain-version calls.
`run_etc1s` packs the codebooks and launches a kind over a tuple of
devices, one launch a shard; `run_etc1s_rgba` and `run_etc1s_etc1` are its
one-device entries, and `parallel/mesh.py` `sharded_etc1s_transcode` (which
every ETC1S file read runs) its mesh entry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import resolve_device, run_shard, shard_bounds, to_device
from ..tables import device_tables
from ..utils.profiling import count, span
from . import build
from .bits import M32, bytes_from_lanes
from .etc import color_5_to_8, etc1_palette, selector_wire_bits
from .kernels import check_out_alignment

KINDS = build.ETC1S_KINDS  # index = the kernel's KIND
OUT_BYTES = {"rgba": 64, "alpha": 64, "rgba_alpha": 64, "etc1": 8}
# the index streams of a kind and the codebook each one reads (0 endpoint,
# 1 selector or wire words)
INDEX_BOOKS = {"rgba": (0, 1), "alpha": (0, 1), "rgba_alpha": (0, 1, 0, 1), "etc1": (0, 1)}

# texel i = 4y + x (row-major) sits at bits 8y + 2x of its selector word
_TEXEL_SHIFTS = [8 * y + 2 * x for y in range(4) for x in range(4)]


# ---------------------------------------------------------------------------
# host packers (etc1s_pallas.py:86-101, without the power-of-two padding)
# ---------------------------------------------------------------------------


def pack_endpoints(endpoints) -> np.ndarray:
    """uint8 [E, 4] (r5, g5, b5, inten3) -> uint32 [E] endpoint words."""
    e = np.asarray(endpoints).astype(np.uint32).reshape(-1, 4)
    return e[:, 0] | (e[:, 1] << 5) | (e[:, 2] << 10) | (e[:, 3] << 15)


def pack_selectors(selectors) -> np.ndarray:
    """uint8 [S, 4] row bytes -> uint32 [S] selector words."""
    s = np.asarray(selectors).astype(np.uint32).reshape(-1, 4)
    return s[:, 0] | (s[:, 1] << 8) | (s[:, 2] << 16) | (s[:, 3] << 24)


def selector_wire_words(selectors) -> np.ndarray:
    """uint8 [S, 4] row bytes -> uint32 [S] ETC1 selector words: texel
    (x, y) at the column-major pixel id x*4 + y (Selector::set_selector,
    etc.rs:374-393)."""
    words = torch.from_numpy(pack_selectors(selectors).astype(np.int64))
    wire = torch.zeros_like(words)
    for x in range(4):
        for y in range(4):
            wire |= selector_wire_bits((words >> (8 * y + 2 * x)) & 3, x * 4 + y)
    return wire.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# plain versions of K6-K9
# ---------------------------------------------------------------------------


def _gather(table, idx):
    """int32 [E] words, uint16 [N] indices -> int64 [N] words in 0..2^32-1
    (uint16 has no indexing operator in torch: the plain version widens)."""
    return table.to(torch.int64)[idx.to(torch.int64)] & M32


def _palette(ep):
    """Endpoint words -> the block's 4-colour palette, [level][channel] int64."""
    base = [color_5_to_8((ep >> (5 * c)) & 31) for c in range(3)]
    return etc1_palette(base, (ep >> 15) & 7, device_tables(ep.device))


def _select(levels, sel):
    """levels: 4 int64 [N] palette values; sel: int64 [N] selector words ->
    int64 [N, 16], texel i takes level (sel >> _TEXEL_SHIFTS[i]) & 3."""
    shifts = torch.tensor(_TEXEL_SHIFTS, dtype=torch.int64, device=sel.device)
    return torch.gather(torch.stack(levels, dim=1), 1, (sel[:, None] >> shifts) & 3)


def _rgb_words(pal):
    return [pal[k][0] | (pal[k][1] << 8) | (pal[k][2] << 16) for k in range(4)]


def rgba_rows(ep_tab, sel_tab, idx, out) -> None:
    """Plain K6: packed RGBA texels, alpha 255, into out uint8 [N, 64]."""
    pal = _palette(_gather(ep_tab, idx[0]))
    words = _select([w | 0xFF000000 for w in _rgb_words(pal)], _gather(sel_tab, idx[1]))
    out.copy_(bytes_from_lanes(words))


def alpha_rows(ep_tab, sel_tab, idx, out) -> None:
    """Plain K7: the palette's G of each texel (mod.rs:139-143) as a word."""
    pal = _palette(_gather(ep_tab, idx[0]))
    out.copy_(bytes_from_lanes(_select([pal[k][1] for k in range(4)], _gather(sel_tab, idx[1]))))


def rgba_alpha_rows(ep_tab, sel_tab, idx, out) -> None:
    """Plain K8: K6's RGB from (idx[0], idx[1]) and the alpha byte from the
    G of the palette of (idx[2], idx[3]), the alpha slice."""
    rgb = _select(_rgb_words(_palette(_gather(ep_tab, idx[0]))), _gather(sel_tab, idx[1]))
    a_pal = _palette(_gather(ep_tab, idx[2]))
    alpha = _select([a_pal[k][1] for k in range(4)], _gather(sel_tab, idx[3]))
    out.copy_(bytes_from_lanes(rgb | (alpha << 24)))


def etc1_rows(ep_tab, wire_tab, idx, out) -> None:
    """Plain K9: ETC1 blocks (mod.rs:163-181).  Lane 0 is a differential
    block with zero deltas: each 5-bit colour << 3 (not the expanded
    palette base), then (inten << 5) | (inten << 2) | 0b11, both codeword
    tables, the diff bit and the flip bit.  Lane 1 is the wire word."""
    ep = _gather(ep_tab, idx[0])
    inten = (ep >> 15) & 7
    lane0 = (
        ((ep & 31) << 3)
        | ((((ep >> 5) & 31) << 3) << 8)
        | ((((ep >> 10) & 31) << 3) << 16)
        | (((inten << 5) | (inten << 2) | 0b11) << 24)
    )
    out.copy_(bytes_from_lanes(torch.stack([lane0, _gather(wire_tab, idx[1])], dim=-1)))


PLAIN = {"rgba": rgba_rows, "alpha": alpha_rows, "rgba_alpha": rgba_alpha_rows, "etc1": etc1_rows}


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


class Etc1sKernel:
    """One ETC1S kind, one launch of `etc1s_kernel<KIND>` over all N blocks."""

    def __init__(self, kind: str):
        self.kind = kind
        self.kind_id = KINDS.index(kind)
        self.out_bytes = OUT_BYTES[kind]
        self.books = INDEX_BOOKS[kind]
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, ep_tab, sel_tab, *idx, out=None, check_index=True):
        """ep_tab, sel_tab: int32 [E], [S] packed codebook words (wire words
        for "etc1"); idx: the kind's uint16 [N] index streams (endpoint,
        selector, and for "rgba_alpha" the alpha slice's endpoint and
        selector).  Every index must be below its codebook's length:
        checked here with one host sync unless check_index is False (the
        front-end already guarantees it).  Returns out, uint8
        [N, OUT_BYTES[kind]], allocated (torch.empty) when not given.
        Spans: `etc1s.launch` (the call), `etc1s.index_check` (the check's
        reduces and its wait)."""
        with span("etc1s.launch"):
            dev = ep_tab.device
            for name, t in (("ep_tab", ep_tab), ("sel_tab", sel_tab)):
                if t.dtype != torch.int32 or t.dim() != 1 or t.device != dev or not t.is_contiguous():
                    raise ValueError(f"{name} must be a contiguous int32 [E] tensor on the codebooks' device")
            if len(idx) != len(self.books):
                raise ValueError(f"{self.kind} takes {len(self.books)} index streams, got {len(idx)}")
            n = idx[0].shape[0] if idx[0].dim() == 1 else -1
            for t in idx:
                if t.dtype != torch.uint16 or t.shape != (n,) or t.device != dev or not t.is_contiguous():
                    raise ValueError("index streams must be contiguous uint16 [N] tensors of one length "
                                     "on the codebooks' device")
            if out is None:
                out = torch.empty(n, self.out_bytes, dtype=torch.uint8, device=dev)
            if (out.dtype != torch.uint8 or out.shape != (n, self.out_bytes) or out.device != dev
                    or not out.is_contiguous()):
                raise ValueError(f"out must be a contiguous uint8 [N, {self.out_bytes}] tensor "
                                 "on the codebooks' device")
            if n == 0:
                return out
            sizes = (ep_tab.shape[0], sel_tab.shape[0])
            if min(sizes) == 0:
                raise ValueError(f"{self.kind}: empty codebook (sizes {sizes}) for {n} blocks")
            if check_index:
                with span("etc1s.index_check"):
                    count("host_syncs")
                    highs = torch.stack([t.to(torch.int32).max() for t in idx]).tolist()
                for k, (hi, book) in enumerate(zip(highs, self.books)):
                    if hi >= sizes[book]:
                        raise ValueError(f"index stream {k} reaches {hi}, past its codebook of {sizes[book]}")
            if dev.type == "cpu":
                self.plain_calls += 1
                PLAIN[self.kind](ep_tab, sel_tab, idx, out)
            elif dev.type == "cuda":
                self._launch(ep_tab, sel_tab, idx, n, out)
            else:
                raise ValueError(f"no ETC1S {self.kind} kernel for device {dev}")
            return out

    def _launch(self, ep_tab, sel_tab, idx, n, out) -> None:
        if n >= 2**31:
            raise ValueError(f"{n} blocks exceed one launch (2^31 - 1)")
        check_out_alignment(out)
        ptrs = [t.data_ptr() for t in idx] + [None] * (4 - len(idx))
        dev = ep_tab.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = build.load().etc1s_launch(
                self.kind_id, ep_tab.data_ptr(), ep_tab.shape[0], sel_tab.data_ptr(), sel_tab.shape[0],
                *ptrs, n, out.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"ETC1S {self.kind} kernel: launch failed, cudaError_t {rc}")
        self.launches += 1
        count("launches")


_KERNELS = {k: Etc1sKernel(k) for k in KINDS}


def etc1s_kernel(kind: str) -> Etc1sKernel:
    return _KERNELS[kind]


def launch_counts() -> dict:
    return {k: w.launches for k, w in _KERNELS.items()}


def plain_call_counts() -> dict:
    return {k: w.plain_calls for k, w in _KERNELS.items()}


def reset_counts() -> None:
    for w in _KERNELS.values():
        w.launches = 0
        w.plain_calls = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def codebook_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> the int32 tensor the wrapper takes, on `device`."""
    return to_device(torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)), device)


def index_tensor(idx, device) -> torch.Tensor:
    """An index stream (numpy or torch, any integer type with values in
    0..65535) as a contiguous uint16 tensor on `device`."""
    if isinstance(idx, torch.Tensor) and idx.dtype == torch.uint16:
        return to_device(idx, device).contiguous()
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        count("host_syncs")
    a = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if a.dtype != np.uint16:
        if a.size and (a.min() < 0 or a.max() > 0xFFFF):
            raise ValueError("ETC1S indices must lie in 0..65535")
        a = a.astype(np.uint16)
    return to_device(torch.from_numpy(np.ascontiguousarray(a).reshape(-1)), device)


def run_etc1s(kind: str, endpoints, selectors, streams, devices: tuple, check_index: bool = True) -> torch.Tensor:
    """Decode ETC1S blocks of `kind` (KINDS) over `devices`: the codebooks
    (endpoints uint8 [E, 4], selectors uint8 [S, 4] row bytes) packed once
    and copied to every device, the index streams (numpy or torch, the
    kind's INDEX_BOOKS order) split contiguously over the devices, each
    shard made uint16 on its device (index_tensor), one launch a shard.
    Every index is checked against its codebook unless check_index is
    False.  Returns the uint32 view of the rows on devices[0] in block
    order: [N, 16] for the texel kinds, [N, 2] for "etc1".  Span:
    `etc1s.pack` (the packers and the codebooks' copies)."""
    n = len(streams[0])
    if any(len(s) != n for s in streams):
        raise ValueError(f"index streams of different lengths: {[len(s) for s in streams]}")
    with span("etc1s.pack"):
        words = (pack_endpoints(endpoints),
                 selector_wire_words(selectors) if kind == "etc1" else pack_selectors(selectors))
        books = {d: [codebook_tensor(w, d) for w in words] for d in set(devices)}
    kernel = etc1s_kernel(kind)
    out = torch.empty(n, OUT_BYTES[kind], dtype=torch.uint8, device=devices[0])
    for d, (a, b) in zip(devices, shard_bounds(n, len(devices))):
        shard = [index_tensor(s[a:b], d) for s in streams]
        run_shard(d, (out[a:b],), lambda o, d=d, shard=shard: kernel(*books[d], *shard, out=o, check_index=check_index))
    return out.view(torch.uint32)


def run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx, alpha_pass=None, device="cuda", check_index=True):
    """Decode ETC1S blocks to packed RGBA texels: uint32 [N, 16] (the view
    of uint8 [N, 64] rows) on `device`.  One launch: K6, or K8 when
    alpha_pass = (ep_idx, sel_idx) of the paired alpha slice gives the
    alpha byte (basis.rs:26-50).  Spans: `etc1s.run`, and run_etc1s'."""
    with span("etc1s.run"):
        kind = "rgba" if alpha_pass is None else "rgba_alpha"
        return run_etc1s(kind, endpoints, selectors, (ep_idx, sel_idx, *(alpha_pass or ())),
                         (resolve_device(device),), check_index)


def run_etc1s_etc1(endpoints, selectors, ep_idx, sel_idx, device="cuda", check_index=True):
    """ETC1S blocks -> ETC1 blocks: uint32 [N, 2] (the view of uint8 [N, 8]
    rows) on `device`, one K9 launch.  Spans as run_etc1s_rgba's."""
    with span("etc1s.run"):
        return run_etc1s("etc1", endpoints, selectors, (ep_idx, sel_idx), (resolve_device(device),), check_index)
