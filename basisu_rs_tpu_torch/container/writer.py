"""UASTC .basis file writer: synthetic files for tests and `chip_smoke.py`.

Port of the UASTC half of `basisu_rs_tpu/container/writer.py`
(`_pack_header`, `_pack_slice_desc`, `write_uastc_basis`): a valid .basis
file from raw UASTC blocks, byte for byte the JAX package's writer's output.
The ETC1S writer is not ported yet (it comes with the ETC1S back-end,
ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import struct

import numpy as np

from .crc import crc16


def _pack_header(
    *,
    data_size: int,
    data_crc16: int,
    total_slices: int,
    total_images: int,
    tex_format: int,
    flags: int,
    tex_type: int,
    slice_desc_ofs: int = 0,
) -> bytes:
    b = bytearray(77)
    struct.pack_into("<4H", b, 0, 0x4273, 0x0D, 77, 0)
    struct.pack_into("<I", b, 8, data_size)
    struct.pack_into("<H", b, 12, data_crc16)
    b[14:17] = total_slices.to_bytes(3, "little")
    b[17:20] = total_images.to_bytes(3, "little")
    b[20] = tex_format
    struct.pack_into("<H", b, 21, flags)
    b[23] = tex_type
    # us_per_frame, reserved, userdata and the ETC1S codebook and table
    # ranges (bytes 24..57) stay zero in a UASTC file
    struct.pack_into("<5I", b, 57, 0, 0, slice_desc_ofs, 0, 0)
    # header CRC over bytes 8..77 (basis.rs:330)
    struct.pack_into("<H", b, 6, crc16(bytes(b[8:77])))
    return bytes(b)


def _pack_slice_desc(image_index, level_index, flags, ow, oh, nbx, nby, file_ofs, file_size, data_crc) -> bytes:
    b = bytearray(23)
    b[0:3] = image_index.to_bytes(3, "little")
    b[3] = level_index
    b[4] = flags
    struct.pack_into("<4H", b, 5, ow, oh, nbx, nby)
    struct.pack_into("<2I", b, 13, file_ofs, file_size)
    struct.pack_into("<H", b, 21, data_crc)
    return bytes(b)


def write_uastc_basis(slices) -> bytes:
    """slices: list of dicts {blocks: uint8 [nby*nbx, 16], nbx, nby,
    orig_width, orig_height, [image_index], [level_index]}.  Returns the
    .basis file bytes."""
    header_size = 77
    slice_desc_ofs = header_size
    payload_ofs = slice_desc_ofs + 23 * len(slices)

    descs = []
    payloads = []
    ofs = payload_ofs
    for i, s in enumerate(slices):
        data = np.ascontiguousarray(s["blocks"], np.uint8).tobytes()
        descs.append(
            _pack_slice_desc(
                s.get("image_index", i), s.get("level_index", 0), 0,
                s["orig_width"], s["orig_height"], s["nbx"], s["nby"],
                ofs, len(data), crc16(data),
            )
        )
        payloads.append(data)
        ofs += len(data)

    body = b"".join(descs) + b"".join(payloads)
    header = _pack_header(
        data_size=len(body),
        data_crc16=crc16(body),
        total_slices=len(slices),
        total_images=len({s.get("image_index", i) for i, s in enumerate(slices)}),
        tex_format=1,  # UASTC4x4
        flags=0,
        tex_type=0,
        slice_desc_ofs=slice_desc_ofs,
    )
    return header + body
