"""Minimal PNG writer for RGBA32 decode output (stdlib zlib only).

Port of `basisu_rs_tpu/container/png.py`, byte for byte: it takes the
port's `Image`, whose `data` is a torch tensor, and copies it to the host
once.

The reference's corpus tests compare full-image RGBA unpacks against PNG
files produced by the official basisu tool (reference: tests/common.rs:15-22,
corpus_tests.rs:8-20); this is the emitting half for our CLI.  8-bit RGBA,
no interlace, filter 0 on every scanline.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(img) -> bytes:
    """Serialize an RGBA `Image` (block-padded buffer, true byte stride) to a
    PNG of its original w x h."""
    data = np.asarray(img.data.cpu(), np.uint8).reshape(-1)
    row_bytes = 4 * img.w
    raw = bytearray()
    for y in range(img.h):
        raw.append(0)  # filter type 0 (None)
        raw += data[y * img.stride : y * img.stride + row_bytes].tobytes()
    ihdr = struct.pack(">IIBBBBB", img.w, img.h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    return (
        _SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(bytes(raw), 6))
        + _chunk(b"IEND", b"")
    )
