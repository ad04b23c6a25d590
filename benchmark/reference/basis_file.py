"""The reference's own .basis container parser: the 77-byte header, its
CRC-16 and the data CRC-16, and the 23-byte slice descriptors (the
reference decoder's basis.rs:307-336 and 417-517 layout).  It shares no
code with the program."""

from __future__ import annotations

import binascii
import struct

HEADER_SIZE = 77
SLICE_DESC_SIZE = 23
SIG = 0x4273
FORMAT_ETC1S, FORMAT_UASTC = 0, 1
FLAG_HAS_ALPHA = 4


class ReferenceError(ValueError):
    """The reference refuses the bytes (a bad CRC, a truncated section, or a
    stream outside the subset it decodes)."""


def crc16(data) -> int:
    """CRC-16/GENIBUS: polynomial 0x1021, initial 0xFFFF, output inverted."""
    return binascii.crc_hqx(data, 0xFFFF) ^ 0xFFFF


def _u24(b, ofs: int) -> int:
    return b[ofs] | (b[ofs + 1] << 8) | (b[ofs + 2] << 16)


def parse(buf: bytes) -> tuple[dict, list[dict]]:
    """(header fields, slice descriptors) of a checked file; raises
    ReferenceError where the reference would refuse the file."""
    if len(buf) < HEADER_SIZE or struct.unpack_from("<H", buf, 0)[0] != SIG:
        raise ReferenceError("not a .basis file")
    h = {}
    (h["header_size"], h["header_crc"], h["data_size"], h["data_crc"]) = struct.unpack_from("<2HIH", buf, 4)
    if h["header_size"] != HEADER_SIZE:
        raise ReferenceError("unexpected header size")
    if crc16(buf[8:HEADER_SIZE]) != h["header_crc"]:
        raise ReferenceError("header CRC16 failed")
    if crc16(buf[HEADER_SIZE:]) != h["data_crc"]:
        raise ReferenceError("data CRC16 failed")
    h["total_slices"] = _u24(buf, 14)
    h["total_images"] = _u24(buf, 17)
    h["tex_format"] = buf[20]
    (h["flags"],) = struct.unpack_from("<H", buf, 21)
    h["tex_type"] = buf[23]
    (h["total_endpoints"], h["endpoint_ofs"]) = struct.unpack_from("<HI", buf, 39)
    h["endpoint_size"] = _u24(buf, 45)
    (h["total_selectors"], h["selector_ofs"]) = struct.unpack_from("<HI", buf, 48)
    h["selector_size"] = _u24(buf, 54)
    (h["tables_ofs"], h["tables_size"], h["slice_ofs"]) = struct.unpack_from("<3I", buf, 57)
    descs = []
    for i in range(h["total_slices"]):
        o = h["slice_ofs"] + i * SLICE_DESC_SIZE
        if o + SLICE_DESC_SIZE > len(buf):
            raise ReferenceError("truncated slice descriptor")
        d = {"image_index": _u24(buf, o), "level_index": buf[o + 3], "flags": buf[o + 4]}
        (d["orig_width"], d["orig_height"], d["nbx"], d["nby"]) = struct.unpack_from("<4H", buf, o + 5)
        (d["file_ofs"], d["file_size"], d["crc"]) = struct.unpack_from("<2IH", buf, o + 13)
        if d["file_ofs"] + d["file_size"] > len(buf):
            raise ReferenceError("truncated slice payload")
        descs.append(d)
    return h, descs


def payload(buf: bytes, desc: dict) -> bytes:
    return buf[desc["file_ofs"] : desc["file_ofs"] + desc["file_size"]]
