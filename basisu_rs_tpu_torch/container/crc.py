"""CRC-16/GENIBUS over file bytes (reference: src/basis.rs:364-372).

`crc16` runs the host C++ of `crc16.cpp`, which `ops.build.host_library`
builds with g++ at first use; a failed build raises.  The C++ has two
paths: a carry-less-multiply fold (x86-64 with PCLMULQDQ, 4 accumulators
over 64-byte strides) and a slice-by-16 table loop.  It picks the fold for
buffers of 128 bytes or more where the CPU has PCLMULQDQ, read once, and
the table otherwise (the 69-byte header CRC, other CPUs); nothing else
chooses.  With the recorder on, `crc16` counts `crc_bytes`, every byte it
reads, and `crc_fold_bytes`, the bytes the fold consumed as the C++
reports them.  `crc16_table` and `crc16_fold` run one path each, for the
tests; `crc16_plain` is the table-driven Python version they are held
against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..ops import build
from ..utils.profiling import count, enabled

SOURCE = Path(__file__).resolve().parent / "crc16.cpp"


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    for fn in (lib.basisu_crc16, lib.basisu_crc16_fold):  # data, len, crc, size_t* fold bytes (or None)
        fn.restype = ctypes.c_uint16
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint16, ctypes.c_void_p]
    lib.basisu_crc16_table.restype = ctypes.c_uint16
    lib.basisu_crc16_table.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint16]
    lib.basisu_crc16_has_fold.restype = ctypes.c_int
    lib.basisu_crc16_has_fold.argtypes = []
    return lib


def crc16(data, crc: int = 0) -> int:
    """CRC of any buffer (bytes, memoryview, uint8 numpy array), read in
    place without a copy."""
    arr = np.frombuffer(data, np.uint8)
    if not enabled():
        return int(_lib().basisu_crc16(arr.ctypes.data, arr.size, crc, None))
    folded = ctypes.c_size_t(0)
    value = int(_lib().basisu_crc16(arr.ctypes.data, arr.size, crc, ctypes.byref(folded)))
    count("crc_bytes", arr.size)
    count("crc_fold_bytes", folded.value)
    return value


def has_fold() -> bool:
    """Whether this CPU runs the fold path."""
    return bool(_lib().basisu_crc16_has_fold())


def crc16_table(data, crc: int = 0) -> int:
    """`crc16` by the table path alone, at any length."""
    arr = np.frombuffer(data, np.uint8)
    return int(_lib().basisu_crc16_table(arr.ctypes.data, arr.size, crc))


def crc16_fold(data, crc: int = 0) -> tuple[int, int]:
    """(CRC, bytes folded) by the fold path at any length (the table alone
    below 16 bytes); only where has_fold()."""
    arr = np.frombuffer(data, np.uint8)
    folded = ctypes.c_size_t(0)
    return int(_lib().basisu_crc16_fold(arr.ctypes.data, arr.size, crc, ctypes.byref(folded))), folded.value


@lru_cache(maxsize=None)
def _crc16_table() -> np.ndarray:
    # crc' = ((crc << 8) ^ k ^ (k << 5) ^ (k << 12)) & 0xFFFF with
    # k = q ^ (q >> 4), q = byte ^ (crc >> 8): the update depends on q
    # only, so tabulate it for q in 0..255.
    q = np.arange(256, dtype=np.uint16)
    k = ((q >> 4) ^ q).astype(np.uint16)
    return (k ^ (k << 5) ^ (k << 12)).astype(np.uint16)


def crc16_plain(data, crc: int = 0) -> int:
    """Table-driven Python CRC-16/GENIBUS, one byte at a time."""
    tbl = _crc16_table()
    c = (~crc) & 0xFFFF
    for b in bytes(data):
        q = (b ^ (c >> 8)) & 0xFF
        c = ((c << 8) & 0xFFFF) ^ int(tbl[q])
    return (~c) & 0xFFFF
