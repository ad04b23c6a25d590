"""Host-side LSB-first bit I/O.

Port of `basisu_rs_tpu/utils/bitio.py`, used by the host parts of the ETC1S
path (the Huffman and codebook decode of the plain front-end, the synthetic
.basis writer).  Semantics match the reference bit-exactly: reads past the
end yield zero bits (reference: src/bitreader.rs:45,55), writes past the
end are dropped (src/bitwriter.rs:34).
"""

from __future__ import annotations


class BitReaderLsb:
    __slots__ = ("data", "bit_pos")

    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.bit_pos += count
        return v

    def read_bool(self) -> bool:
        return self.read(1) == 1

    def remove(self, count: int) -> None:
        self.bit_pos += count

    def peek(self, count: int) -> int:
        assert count <= 32
        byte = self.bit_pos >> 3
        bit = self.bit_pos & 7
        # up to 5 bytes, zero-padded past the end
        chunk = self.data[byte : byte + 5]
        acc = int.from_bytes(chunk, "little") >> bit
        return acc & ((1 << count) - 1)


class BitWriterLsb:
    __slots__ = ("bits", "bit_pos")

    def __init__(self):
        self.bits: list[tuple[int, int, int]] = []  # (pos, count, value)
        self.bit_pos = 0

    def write(self, count: int, value: int) -> None:
        assert count <= 32
        self.bits.append((self.bit_pos, count, value & ((1 << count) - 1)))
        self.bit_pos += count

    def getvalue(self) -> bytes:
        nbytes = (self.bit_pos + 7) // 8
        acc = 0
        for pos, _count, value in self.bits:
            acc |= value << pos
        return acc.to_bytes(max(nbytes, 1), "little") if self.bit_pos else b""
