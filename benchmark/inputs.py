"""The benchmark's inputs, drawn from the seed: UASTC blocks, ETC1S
codebooks and index streams, and .basis files of mip-chained textures.

The file writers are a frozen copy of the program's synthetic writer
(container/writer.py), cut to what the benchmark writes and extended by
mip levels: UASTC slices back to back; ETC1S with equal-length canonical
Huffman codes, a raw selector codebook, the endpoint prediction symbol
255 (every block's endpoint a delta from the one before it) at each 2x2
group and no selector history.  CRC-16/GENIBUS comes from binascii."""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np

from .reference.basis_file import crc16

GOLDEN = Path(__file__).resolve().parent / "data" / "golden_blocks.npz"
MAX_CODE_SIZE = 16
# order in which the code-length codes' sizes appear in a table (huffman.rs:52-56)
CODELENGTH_INDICES = (17, 18, 19, 20, 0, 8, 7, 9, 6, 0xA, 5, 0xB, 4, 0xC, 3, 0xD, 2, 0xE, 1, 0xF, 0x10)


def golden_blocks() -> np.ndarray:
    """uint8 [608,16]: 32 valid UASTC blocks of each of the 19 modes."""
    with np.load(GOLDEN) as d:
        return d["bc7_in"]


def mip_chain(side: int) -> list[tuple[int, int, int, int]]:
    """(width, height, blocks across, blocks down) of each level of a
    square texture's full mip chain, down to 1x1."""
    levels, s = [], side
    while True:
        nb = (s + 3) // 4
        levels.append((s, s, nb, nb))
        if s == 1:
            return levels
        s = max(1, s // 2)


# ---------------------------------------------------------------------------
# bit writer and canonical Huffman codes
# ---------------------------------------------------------------------------


class BitWriter:
    """LSB-first bit writer."""

    def __init__(self):
        self.acc = 0
        self.pos = 0

    def write(self, count: int, value: int) -> None:
        self.acc |= (value & ((1 << count) - 1)) << self.pos
        self.pos += count

    def getvalue(self) -> bytes:
        return self.acc.to_bytes((self.pos + 7) // 8, "little") if self.pos else b""


class CanonicalEncoder:
    """Canonical Huffman codes of the given code sizes, bit-reversed for an
    LSB-first reader."""

    def __init__(self, sizes):
        self.sizes = list(sizes)
        counts = [0] * (MAX_CODE_SIZE + 1)
        for s in self.sizes:
            counts[s] += 1
        counts[0] = 0
        next_code, total = [0] * (MAX_CODE_SIZE + 1), 0
        for bits in range(1, MAX_CODE_SIZE + 1):
            total = (total + counts[bits - 1]) << 1
            next_code[bits] = total
        self.codes = {}
        for sym, size in enumerate(self.sizes):
            if size:
                code = next_code[size]
                next_code[size] += 1
                self.codes[sym] = (int(f"{code:0{size}b}"[::-1], 2), size)

    def encode(self, w: BitWriter, sym: int) -> None:
        code, size = self.codes[sym]
        w.write(size, code)

    def code_table(self) -> tuple[np.ndarray, np.ndarray]:
        """(code, size) of every symbol as uint64 arrays (0, 0 where unused)."""
        code, size = np.zeros(len(self.sizes), np.uint64), np.zeros(len(self.sizes), np.uint64)
        for sym, (c, s) in self.codes.items():
            code[sym], size[sym] = c, s
        return code, size


def equal_length_sizes(num_symbols: int) -> list[int]:
    return [max(1, math.ceil(math.log2(num_symbols)))] * num_symbols


def write_huffman_table(w: BitWriter, sizes) -> CanonicalEncoder:
    """A table definition: every symbol's length spelled out, 5-bit meta-codes."""
    sizes = list(sizes)
    w.write(14, len(sizes))
    meta_sizes = [0] * 21
    for v in set(sizes):
        meta_sizes[v] = 5
    meta = CanonicalEncoder(meta_sizes)
    w.write(5, 21)
    for idx in CODELENGTH_INDICES:
        w.write(3, meta_sizes[idx] & 7)
    for v in sizes:
        meta.encode(w, v)
    return CanonicalEncoder(sizes)


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


def _header(*, body: bytes, total_slices: int, tex_format: int, flags: int, endpoints=0, endpoint_ofs=0,
            endpoint_size=0, selectors=0, selector_ofs=0, selector_size=0, tables_ofs=0, tables_size=0,
            slice_desc_ofs=77) -> bytes:
    b = bytearray(77)
    struct.pack_into("<4H", b, 0, 0x4273, 0x0D, 77, 0)
    struct.pack_into("<IH", b, 8, len(body), crc16(body))
    b[14:17] = total_slices.to_bytes(3, "little")
    b[17:20] = (1).to_bytes(3, "little")  # one texture a file
    b[20] = tex_format
    struct.pack_into("<H", b, 21, flags)
    struct.pack_into("<HI", b, 39, endpoints, endpoint_ofs)
    b[45:48] = endpoint_size.to_bytes(3, "little")
    struct.pack_into("<HI", b, 48, selectors, selector_ofs)
    b[54:57] = selector_size.to_bytes(3, "little")
    struct.pack_into("<5I", b, 57, tables_ofs, tables_size, slice_desc_ofs, 0, 0)
    struct.pack_into("<H", b, 6, crc16(bytes(b[8:77])))
    return bytes(b)


def _slice_desc(level: int, w: int, h: int, nbx: int, nby: int, ofs: int, data: bytes) -> bytes:
    b = bytearray(23)
    b[0:3] = (0).to_bytes(3, "little")  # image 0
    b[3] = level
    struct.pack_into("<4H2IH", b, 5, w, h, nbx, nby, ofs, len(data), crc16(data))
    return bytes(b)


def _descs(levels, payloads, first_ofs: int) -> bytes:
    descs, ofs = [], first_ofs
    for lvl, ((w, h, nbx, nby), data) in enumerate(zip(levels, payloads)):
        descs.append(_slice_desc(lvl, w, h, nbx, nby, ofs, data))
        ofs += len(data)
    return b"".join(descs)


def uastc_file(rng: np.random.Generator, side: int, pool: np.ndarray) -> bytes:
    """A UASTC .basis file of one side x side texture and its full mip
    chain, every block drawn from pool (uint8 [K,16]) with replacement."""
    levels = mip_chain(side)
    n = sum(nbx * nby for _w, _h, nbx, nby in levels)
    blocks = pool[rng.integers(0, len(pool), n)]
    payloads, start = [], 0
    for _w, _h, nbx, nby in levels:
        payloads.append(blocks[start : start + nbx * nby].tobytes())
        start += nbx * nby
    body = _descs(levels, payloads, 77 + 23 * len(levels)) + b"".join(payloads)
    return _header(body=body, total_slices=len(levels), tex_format=1, flags=0) + body


# ---------------------------------------------------------------------------
# ETC1S
# ---------------------------------------------------------------------------


def etc1s_codebooks(rng: np.random.Generator, n_endpoints: int, n_selectors: int):
    """(uint8 [E,4] endpoints r5, g5, b5, inten3; uint8 [S,4] selector row
    bytes), uniform."""
    endpoints = np.concatenate(
        [rng.integers(0, 32, (n_endpoints, 3), dtype=np.uint8), rng.integers(0, 8, (n_endpoints, 1), dtype=np.uint8)],
        axis=1,
    )
    return endpoints, rng.integers(0, 256, (n_selectors, 4), dtype=np.uint8)


def _endpoint_codebook(endpoints: np.ndarray) -> bytes:
    w = BitWriter()
    color = [write_huffman_table(w, equal_length_sizes(32)) for _ in range(3)]
    inten = write_huffman_table(w, equal_length_sizes(8))
    w.write(1, 0)  # not grayscale
    prev_c, prev_i = [16, 16, 16], 0
    for e in endpoints.tolist():
        inten.encode(w, (e[3] - prev_i) & 7)
        prev_i = e[3]
        for c in range(3):
            p = prev_c[c]
            color[0 if p <= 9 else (1 if p <= 21 else 2)].encode(w, (e[c] - p) & 31)
            prev_c[c] = e[c]
    return w.getvalue()


def _selector_codebook(selectors: np.ndarray) -> bytes:
    # not global, not hybrid, raw: 3 bits, then 4 row bytes an entry
    w = BitWriter()
    w.write(3, 0b100)
    for byte in selectors.reshape(-1).tolist():
        w.write(8, byte)
    return w.getvalue()


def _pack_fields(values: np.ndarray, widths: np.ndarray) -> bytes:
    """The bytes of writing widths[k] bits of values[k] for k = 0, 1, ...,
    LSB first; each field at most 57 bits wide."""
    total = int(widths.sum())
    if total == 0:
        return b""
    pos = np.cumsum(widths, dtype=np.int64) - widths
    shifted = values.astype(np.uint64) << (pos & 7).astype(np.uint64)
    byte = pos >> 3
    nbytes = (total + 7) // 8
    out = np.zeros(nbytes + 8, np.float64)
    # disjoint bits: summing each byte's shares equals OR-ing them, exactly in float64
    for k in range(8):
        part = (shifted >> np.uint64(8 * k)) & np.uint64(0xFF)
        if not part.any():
            break
        out += np.bincount(byte + k, weights=part.astype(np.float64), minlength=nbytes + 8)
    return out[:nbytes].astype(np.uint8).tobytes()


def _etc1s_payload(ep: np.ndarray, sel: np.ndarray, nbx: int, nby: int, n_ep: int, pred, delta_codes, sel_codes):
    """In raster order: the 1-bit prediction symbol at the top-left block of
    each 2x2 group, then each block's endpoint delta from the block before
    it (0 before the first) and its selector index."""
    ep, sel = ep.astype(np.int64), sel.astype(np.int64)
    delta = np.diff(ep, prepend=0) % n_ep
    (pc, pw), (dc, dw), (sc, sw) = pred, delta_codes, sel_codes
    by, bx = np.divmod(np.arange(nbx * nby), nbx)
    group = ((bx % 2 == 0) & (by % 2 == 0)).astype(np.uint64)
    pred_w = group * np.uint64(pw)
    values = (group * np.uint64(pc)) | (dc[delta] << pred_w) | (sc[sel] << (pred_w + dw[delta]))
    return _pack_fields(values, (pred_w + dw[delta] + sw[sel]).astype(np.int64))


def etc1s_file(rng: np.random.Generator, side: int, n_endpoints: int, n_selectors: int) -> bytes:
    """An ETC1S .basis file of one side x side texture and its full mip
    chain: codebooks of its own, uniform endpoint and selector indices."""
    endpoints, selectors = etc1s_codebooks(rng, n_endpoints, n_selectors)
    levels = mip_chain(side)
    ep_cb, sel_cb = _endpoint_codebook(endpoints), _selector_codebook(selectors)
    tw = BitWriter()
    pred_enc = write_huffman_table(tw, [0] * 255 + [1])
    delta_enc = write_huffman_table(tw, equal_length_sizes(n_endpoints))
    sel_enc = write_huffman_table(tw, equal_length_sizes(n_selectors))
    write_huffman_table(tw, [1])  # selector history run model: unused, must parse
    tw.write(13, 0)  # no selector history
    tables = tw.getvalue()
    args = (n_endpoints, pred_enc.codes[255], delta_enc.code_table(), sel_enc.code_table())
    payloads = []
    for _w, _h, nbx, nby in levels:
        n = nbx * nby
        ep = rng.integers(0, n_endpoints, n)
        sel = rng.integers(0, n_selectors, n)
        payloads.append(_etc1s_payload(ep, sel, nbx, nby, *args))
    ep_ofs = 77
    sel_ofs = ep_ofs + len(ep_cb)
    tab_ofs = sel_ofs + len(sel_cb)
    desc_ofs = tab_ofs + len(tables)
    body = ep_cb + sel_cb + tables + _descs(levels, payloads, desc_ofs + 23 * len(levels)) + b"".join(payloads)
    return _header(
        body=body, total_slices=len(levels), tex_format=0, flags=1, endpoints=n_endpoints, endpoint_ofs=ep_ofs,
        endpoint_size=len(ep_cb), selectors=n_selectors, selector_ofs=sel_ofs, selector_size=len(sel_cb),
        tables_ofs=tab_ofs, tables_size=len(tables), slice_desc_ofs=desc_ofs,
    ) + body
