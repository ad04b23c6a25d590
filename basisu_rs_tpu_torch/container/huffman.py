"""Canonical Huffman decoding of the BasisLZ front-end (host side).

Port of `basisu_rs_tpu/container/huffman.py`, mirroring the reference
(src/basis_lz/huffman.rs): a table read is a 14-bit symbol count, a code
for the code lengths (at most 21 of them, in scrambled order) and the
RLE-coded code length of each symbol; decode assigns canonical codes
(JPEG-style), bit-reversed for the LSB-first stream, into a flat
`1 << max_code_size` lookup.  This is the plain version the tests hold the
C++ front-end (`etc1s_frontend.cpp`) against.
"""

from __future__ import annotations

import numpy as np

from ..utils.bitio import BitReaderLsb

MAX_SUPPORTED_CODE_SIZE = 16
MAX_SYMS_LOG2 = 14

_SMALL_ZERO_RUN_MIN = 3
_SMALL_ZERO_RUN_EXTRA = 3
_BIG_ZERO_RUN_MIN = 11
_BIG_ZERO_RUN_EXTRA = 7
_SMALL_REPEAT_MIN = 3
_SMALL_REPEAT_EXTRA = 2
_BIG_REPEAT_MIN = 7
_BIG_REPEAT_EXTRA = 7

_SMALL_ZERO_RUN_CODE = 17
_BIG_ZERO_RUN_CODE = 18
_SMALL_REPEAT_CODE = 19
_BIG_REPEAT_CODE = 20

TOTAL_CODELENGTH_CODES = 21

# Scrambled order in which the code-length codes' sizes appear in the stream
# (huffman.rs:52-56).
CODELENGTH_INDICES = (
    _SMALL_ZERO_RUN_CODE, _BIG_ZERO_RUN_CODE, _SMALL_REPEAT_CODE, _BIG_REPEAT_CODE,
    0, 8, 7, 9, 6, 0xA, 5, 0xB, 4, 0xC, 3, 0xD, 2, 0xE, 1, 0xF, 0x10,
)


class HuffmanError(ValueError):
    pass


class HuffmanDecodingTable:
    """Flat-lookup canonical Huffman decoder (huffman.rs:133-198)."""

    __slots__ = ("symbols", "code_sizes", "max_code_size")

    def __init__(self, symbols: np.ndarray, code_sizes: np.ndarray, max_code_size: int):
        self.symbols = symbols
        self.code_sizes = code_sizes
        self.max_code_size = max_code_size

    @classmethod
    def from_sizes(cls, sizes) -> "HuffmanDecodingTable":
        sizes = np.asarray(sizes, np.uint8)
        counts = np.bincount(sizes, minlength=MAX_SUPPORTED_CODE_SIZE + 1)
        max_code_size = int(sizes.max(initial=0))

        next_code = np.zeros(MAX_SUPPORTED_CODE_SIZE + 1, np.uint32)
        total = 0
        counts0 = counts.copy()
        counts0[0] = 0
        for bits in range(1, MAX_SUPPORTED_CODE_SIZE + 1):
            total = (total + int(counts0[bits - 1])) << 1
            next_code[bits] = total

        lookup_syms = np.zeros(1 << max_code_size, np.uint16)
        lookup_sizes = np.zeros(1 << max_code_size, np.uint8)

        for sym, size in enumerate(sizes):
            size = int(size)
            if size == 0:
                continue
            code = int(next_code[size])
            next_code[size] += 1
            # the code bit-reversed to `size` bits (LSB-first stream)
            rev = int(f"{code:0{size}b}"[::-1], 2)
            step = 1 << size
            lookup_syms[rev::step] = sym
            lookup_sizes[rev::step] = size

        if np.any(next_code > 0x10000):
            raise HuffmanError("Code lengths are invalid, codes don't fit into 16 bits")

        return cls(lookup_syms, lookup_sizes, max_code_size)

    def decode_symbol(self, reader: BitReaderLsb) -> int:
        bits = reader.peek(self.max_code_size)
        size = int(self.code_sizes[bits])
        if size == 0:
            raise HuffmanError(f"No matching code found in the decoding table, bits: {bits:016b}")
        reader.remove(size)
        return int(self.symbols[bits])


def read_huffman_table(reader: BitReaderLsb) -> HuffmanDecodingTable:
    """Read a Huffman table definition from the stream (huffman.rs:43-118)."""
    total_used_syms = reader.read(MAX_SYMS_LOG2)

    num_codelength_codes = reader.read(5)
    codelength_sizes = np.zeros(TOTAL_CODELENGTH_CODES, np.uint8)
    for i in range(num_codelength_codes):
        codelength_sizes[CODELENGTH_INDICES[i]] = reader.read(3)
    codelength_table = HuffmanDecodingTable.from_sizes(codelength_sizes)

    sizes: list[int] = []
    while len(sizes) < total_used_syms:
        sym = codelength_table.decode_symbol(reader)
        if sym <= 16:
            sizes.append(sym)
        elif sym == _SMALL_ZERO_RUN_CODE:
            sizes.extend([0] * (_SMALL_ZERO_RUN_MIN + reader.read(_SMALL_ZERO_RUN_EXTRA)))
        elif sym == _BIG_ZERO_RUN_CODE:
            sizes.extend([0] * (_BIG_ZERO_RUN_MIN + reader.read(_BIG_ZERO_RUN_EXTRA)))
        elif sym in (_SMALL_REPEAT_CODE, _BIG_REPEAT_CODE):
            if not sizes:
                raise HuffmanError("Encountered RepeatCode as the first code")
            prev = sizes[-1]
            if prev == 0:
                raise HuffmanError("RepeatCode after a zero-length code")
            if sym == _SMALL_REPEAT_CODE:
                count = _SMALL_REPEAT_MIN + reader.read(_SMALL_REPEAT_EXTRA)
            else:
                count = _BIG_REPEAT_MIN + reader.read(_BIG_REPEAT_EXTRA)
            sizes.extend([prev] * count)
        else:  # pragma: no cover - symbols are <= 20 by construction
            raise HuffmanError(f"invalid code-length symbol {sym}")

    return HuffmanDecodingTable.from_sizes(sizes)
