"""KTX (v1) container writer for transcoded images.

The reference never *emits* GPU container files, but its corpus tests consume
exactly these: KTX files holding BC7 / ASTC 4x4 / ETC1 / ETC2 payloads
produced by the official basisu tool (reference: tests/common.rs:15-22,
tests/corpus_tests.rs:4-73).  This writer closes the loop so the CLI can
produce directly loadable textures from a .basis input.

Port of `basisu_rs_tpu/container/ktx.py`, byte for byte; each image's torch
`data` is copied to the host once.

Layout per the Khronos KTX 1.1 specification: 12-byte identifier, 13 LE u32
header words, then per mip level a u32 imageSize followed by the payload
padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])
_ENDIANNESS = 0x04030201

# target -> (glType, glTypeSize, glFormat, glInternalFormat, glBaseInternalFormat,
#            bytes per 4x4 block or per texel)
_GL_RGBA8 = (0x1401, 1, 0x1908, 0x8058, 0x1908, 4)  # UNSIGNED_BYTE / RGBA / RGBA8
_FORMATS = {
    "bc7": (0, 1, 0, 0x8E8C, 0x1908, 16),  # COMPRESSED_RGBA_BPTC_UNORM
    "astc": (0, 1, 0, 0x93B0, 0x1908, 16),  # COMPRESSED_RGBA_ASTC_4x4_KHR
    "etc1": (0, 1, 0, 0x8D64, 0x1907, 8),  # ETC1_RGB8_OES
    "etc2": (0, 1, 0, 0x9278, 0x1908, 16),  # COMPRESSED_RGBA8_ETC2_EAC
    "rgba": _GL_RGBA8,
}


def host_bytes(img) -> np.ndarray:
    """The image's data as flat host uint8 (one copy off the device)."""
    return np.asarray(img.data.cpu(), np.uint8).reshape(-1)


def _rgba_rows(img) -> bytes:
    """Tightly packed rows at the original width (the decode buffer is
    block-padded: stride = 4 * 4 * num_blocks_x bytes)."""
    data = host_bytes(img)
    row_bytes = 4 * img.w
    stride = img.stride
    rows = [data[y * stride : y * stride + row_bytes] for y in range(img.h)]
    return b"".join(r.tobytes() for r in rows)


def write_ktx(images, target: str) -> bytes:
    """Serialize a mip chain of `Image`s (level 0 first, each level half the
    previous, as produced by read_to_* over one .basis image) into a KTX blob.

    target: one of rgba/astc/bc7/etc1/etc2 (uastc has no GL enum)."""
    if target not in _FORMATS:
        raise ValueError(f"no KTX format mapping for target {target!r}")
    if not images:
        raise ValueError("no images")
    # KTX loaders derive level-N dimensions as max(1, level0 >> N) from the
    # header alone; a non-halving chain would make per-level imageSize
    # disagree with loader-derived dimensions (silently broken texture).
    for n, img in enumerate(images):
        ew, eh = max(1, images[0].w >> n), max(1, images[0].h >> n)
        if (img.w, img.h) != (ew, eh):
            raise ValueError(
                f"mip level {n} is {img.w}x{img.h}, but KTX requires the "
                f"halving chain {ew}x{eh} from level 0 ({images[0].w}x{images[0].h})"
            )
    gl_type, gl_type_size, gl_format, gl_internal, gl_base, _unit = _FORMATS[target]

    head = images[0]
    header = struct.pack(
        "<13I",
        _ENDIANNESS,
        gl_type,
        gl_type_size,
        gl_format,
        gl_internal,
        gl_base,
        head.w,
        head.h,
        0,  # pixelDepth (2-D)
        0,  # numberOfArrayElements
        1,  # numberOfFaces
        len(images),
        0,  # bytesOfKeyValueData
    )
    out = bytearray(_IDENTIFIER)
    out += header

    for img in images:
        if target == "rgba":
            payload = _rgba_rows(img)
        else:
            payload = host_bytes(img).tobytes()
        out += struct.pack("<I", len(payload))
        out += payload
        out += b"\x00" * ((-len(payload)) % 4)
    return bytes(out)


def group_mip_chains(images, descs):
    """Split the flat slice list from read_to_* into per-image mip chains
    using the slice descriptors' (image_index, level_index).  images and
    descs must pair 1:1 (callers drop alpha descs when the reader merged
    RGB+A slice pairs)."""
    chains: dict[int, list] = {}
    for img, d in zip(images, descs, strict=True):
        chains.setdefault(d.image_index, []).append((d.level_index, img))
    return [
        [img for _, img in sorted(chain, key=lambda t: t[0])]
        for _, chain in sorted(chains.items())
    ]
