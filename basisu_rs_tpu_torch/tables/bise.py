"""ASTC Bounded Integer Sequence Encoding (BISE) range table.

The 21 quantization ranges and their dequantization parameters, per the ASTC
spec (reference: src/target_formats/astc.rs:299-331).  `deq_b` encodes, for
each of the 9 output bits (MSB first), which raw bit of the quantized value is
scattered there ('a' = bit 0, 'b' = bit 1, ..., '0'/' ' = zero).

The port's own copy of `basisu_rs_tpu/tables/bise.py`, held equal to it by
tests/test_torch_tables.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class BiseRange:
    bits: int
    trits: int
    quints: int
    deq_b: str  # 9-char scatter pattern, MSB first
    deq_c: int

    @property
    def scatter_pairs(self) -> tuple[tuple[int, int], ...]:
        """(output_bit, input_bit) pairs realizing the deq_b scatter."""
        pairs = []
        for j, ch in enumerate(self.deq_b):
            if ch not in ("0", " "):
                out_bit = 8 - j  # b is built MSB-first over 9 bits
                in_bit = ord(ch) - ord("a")
                pairs.append((out_bit, in_bit))
        return tuple(pairs)

    @property
    def max_quant(self) -> int:
        """Number of distinct quantized levels in this range."""
        n = 1 << self.bits
        if self.trits:
            n *= 3
        if self.quints:
            n *= 5
        return n


_R = BiseRange
BISE_RANGES: tuple[BiseRange, ...] = (
    _R(1, 0, 0, "         ", 0),    # 0
    _R(0, 1, 0, "         ", 0),    # 1
    _R(2, 0, 0, "         ", 0),    # 2
    _R(0, 0, 1, "         ", 0),    # 3
    _R(1, 1, 0, "000000000", 204),  # 4
    _R(3, 0, 0, "         ", 0),    # 5
    _R(1, 0, 1, "000000000", 113),  # 6
    _R(2, 1, 0, "b000b0bb0", 93),   # 7
    _R(4, 0, 0, "         ", 0),    # 8
    _R(2, 0, 1, "b0000bb00", 54),   # 9
    _R(3, 1, 0, "cb000cbcb", 44),   # 10
    _R(5, 0, 0, "         ", 0),    # 11
    _R(3, 0, 1, "cb0000cbc", 26),   # 12
    _R(4, 1, 0, "dcb000dcb", 22),   # 13
    _R(6, 0, 0, "         ", 0),    # 14
    _R(4, 0, 1, "dcb0000dc", 13),   # 15
    _R(5, 1, 0, "edcb000ed", 11),   # 16
    _R(7, 0, 0, "         ", 0),    # 17
    _R(5, 0, 1, "edcb0000e", 6),    # 18
    _R(6, 1, 0, "fedcb000f", 5),    # 19
    _R(8, 0, 0, "         ", 0),    # 20
)


def unquant_endpoint_scalar(trit_quint: int, bits: int, range_index: int) -> int:
    """Scalar endpoint dequantization (reference: uastc.rs:585-614).

    Used host-side for table generation and tests; the kernels implement the
    same arithmetic vectorized.
    """
    rng = BISE_RANGES[range_index]
    if rng.trits == 0 and rng.quints == 0 and rng.bits > 0:
        bits_la = (bits << (8 - rng.bits)) & 0xFFFF
        val = 0
        while bits_la > 0:
            val |= bits_la
            bits_la >>= rng.bits
        return val & 0xFF
    a = 511 if (bits & 1) else 0
    b = 0
    for out_bit, in_bit in rng.scatter_pairs:
        b |= ((bits >> in_bit) & 1) << out_bit
    val = trit_quint * rng.deq_c + b
    val ^= a
    return (a & 0x80) | (val >> 2)


@lru_cache(maxsize=None)
def unquant_lut(range_index: int):
    """uint8 LUT for trit/quint dequantization: index = trit_quint << bits |
    raw_bits.  Tiny (<= 192 entries); lets kernels replace the per-endpoint
    scatter/mul/xor chain with one small gather."""
    rng = BISE_RANGES[range_index]
    assert rng.trits or rng.quints
    base = 3 if rng.trits else 5
    out = np.zeros(base << rng.bits, np.uint8)
    for tq in range(base):
        for b in range(1 << rng.bits):
            out[(tq << rng.bits) | b] = unquant_endpoint_scalar(tq, b, range_index)
    return out
