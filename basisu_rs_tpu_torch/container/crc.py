"""CRC-16/GENIBUS over file bytes (reference: src/basis.rs:364-372).

`crc16` runs the host C++ loop of `crc16.cpp`, which `ops.build.host_library`
builds with g++ at first use; a failed build raises.  `crc16_plain` is the
table-driven Python version the tests hold it against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..ops import build

SOURCE = Path(__file__).resolve().parent / "crc16.cpp"


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    lib.basisu_crc16.restype = ctypes.c_uint16
    lib.basisu_crc16.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint16]
    return lib


def crc16(data, crc: int = 0) -> int:
    """CRC of any buffer (bytes, memoryview, uint8 numpy array), read in
    place without a copy."""
    arr = np.frombuffer(data, np.uint8)
    return int(_lib().basisu_crc16(arr.ctypes.data, arr.size, crc))


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
