"""KTX2 container writer for transcoded images.

KTX2 is the current Khronos texture container (and the official Basis
Universal tool's preferred output).  The reference crate neither reads nor
writes it (its corpus tests consume KTX v1, tests/common.rs:15-22); this
writer is a forward-looking addition so the CLI can emit modern containers:
`python -m basisu_rs_tpu_torch transcode --container ktx2`.

Port of `basisu_rs_tpu/container/ktx2.py`, byte for byte (the KTXwriter
entry still names `basisu_rs_tpu`, so both packages write the same bytes);
each image's torch `data` is copied to the host once.

Layout per the KTX File Format Specification 2.0:
  12-byte identifier, 9 u32 header words, 2x(u32,u32) + (u64,u64) section
  index, levelCount x 3 u64 level index, DFD, KVD, then level payloads with
  the LAST level first in the file, each aligned to
  lcm(texel_block_size, 4) (supercompressionScheme = 0 here).

The Data Format Descriptor is the mandatory KDFS 1.3 basic block: one
sample for the block-compressed formats (color model BC7/ETC1/ETC2/ASTC),
four samples for RGBA8.
"""

from __future__ import annotations

import struct

from .ktx import host_bytes

_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])

# KDFS 1.3 khr_df_model values
_MODEL_RGBSDA = 1
_MODEL_BC7 = 134
_MODEL_ETC1 = 160
_MODEL_ETC2 = 161
_MODEL_ASTC = 162

# target -> (vkFormat, bytes per texel block, block dims (w, h), df model,
#            per-sample (channelType, bitOffset, bitLength))
_FORMATS = {
    # VK_FORMAT_BC7_UNORM_BLOCK
    "bc7": (145, 16, (4, 4), _MODEL_BC7, [(0, 0, 128)]),
    # VK_FORMAT_ASTC_4x4_UNORM_BLOCK
    "astc": (157, 16, (4, 4), _MODEL_ASTC, [(0, 0, 128)]),
    # VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK (ETC1 payloads are a compatible subset)
    "etc1": (147, 8, (4, 4), _MODEL_ETC1, [(0, 0, 64)]),
    # VK_FORMAT_ETC2_R8G8B8A8_UNORM_BLOCK (EAC alpha block + ETC2 color block)
    "etc2": (151, 16, (4, 4), _MODEL_ETC2, [(15, 0, 64), (2, 64, 64)]),
    # VK_FORMAT_R8G8B8A8_UNORM
    "rgba": (37, 4, (1, 1), _MODEL_RGBSDA, [(0, 0, 8), (1, 8, 8), (2, 16, 8), (15, 24, 8)]),
}

_KHR_DF_SAMPLE_DATATYPE_LINEAR = 1 << 4  # qualifier bit on channelType high nibble


def _dfd(target: str) -> bytes:
    """KDFS 1.3 basic descriptor block wrapped with its u32 totalSize."""
    vk, block_bytes, (bw, bh), model, samples = _FORMATS[target]
    n = len(samples)
    block_size = 24 + 16 * n
    out = bytearray()
    out += struct.pack("<I", 4 + block_size)  # dfdTotalSize
    out += struct.pack("<I", 0)  # vendorId 0 (Khronos) | descriptorType 0
    out += struct.pack("<I", (2) | (block_size << 16))  # versionNumber 2
    color_primaries = 1  # KHR_DF_PRIMARIES_BT709
    transfer = 1  # KHR_DF_TRANSFER_LINEAR (we decode UNORM data)
    flags = 0  # KHR_DF_FLAG_ALPHA_STRAIGHT
    out += bytes([model, color_primaries, transfer, flags])
    out += bytes([bw - 1, bh - 1, 0, 0])  # texelBlockDimension0..3
    out += bytes([block_bytes, 0, 0, 0, 0, 0, 0, 0])  # bytesPlane0..7
    for channel, bit_ofs, bit_len in samples:
        # alpha samples of UNORM data stay "linear" per KDFS convention
        qual = _KHR_DF_SAMPLE_DATATYPE_LINEAR if channel == 15 and target != "rgba" else 0
        word0 = bit_ofs | ((bit_len - 1) << 16) | ((channel | qual) << 24)
        out += struct.pack("<I", word0)
        out += struct.pack("<I", 0)  # samplePosition0..3
        out += struct.pack("<I", 0)  # sampleLower
        out += struct.pack("<I", 0xFFFFFFFF)  # sampleUpper
    return bytes(out)


def _kvd() -> bytes:
    """Key/value data: the spec-recommended KTXwriter entry, 4-aligned."""
    kv = b"KTXwriter\x00basisu_rs_tpu\x00"
    entry = struct.pack("<I", len(kv)) + kv
    pad = (-len(entry)) % 4
    return entry + b"\x00" * pad


def _rgba_rows(img) -> bytes:
    data = host_bytes(img)
    row_bytes = 4 * img.w
    rows = [data[y * img.stride : y * img.stride + row_bytes] for y in range(img.h)]
    return b"".join(r.tobytes() for r in rows)


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def write_ktx2(images, target: str) -> bytes:
    """Serialize a mip chain of `Image`s (level 0 first, strictly halving)
    into a KTX2 blob (2-D, no array layers, no supercompression)."""
    if target not in _FORMATS:
        raise ValueError(f"no KTX2 format mapping for target {target!r}")
    if not images:
        raise ValueError("no images")
    for n, img in enumerate(images):
        ew, eh = max(1, images[0].w >> n), max(1, images[0].h >> n)
        if (img.w, img.h) != (ew, eh):
            raise ValueError(
                f"mip level {n} is {img.w}x{img.h}, but KTX2 requires the "
                f"halving chain {ew}x{eh} from level 0 ({images[0].w}x{images[0].h})"
            )

    vk, block_bytes, _dims, _model, _samples = _FORMATS[target]
    payloads = []
    for img in images:
        if target == "rgba":
            payloads.append(_rgba_rows(img))
        else:
            payloads.append(host_bytes(img).tobytes())

    dfd = _dfd(target)
    kvd = _kvd()
    n_levels = len(images)

    header = struct.pack(
        "<9I",
        vk,
        1,  # typeSize (block-compressed and u8 data)
        images[0].w,
        images[0].h,
        0,  # pixelDepth (2-D)
        0,  # layerCount (not an array)
        1,  # faceCount
        n_levels,
        0,  # supercompressionScheme: none
    )
    fixed = 12 + len(header) + 2 * 8 + 2 * 8 + n_levels * 24
    dfd_ofs = fixed
    kvd_ofs = dfd_ofs + len(dfd)
    index = struct.pack("<2I2I2Q", dfd_ofs, len(dfd), kvd_ofs, len(kvd), 0, 0)

    # level payloads: LAST (smallest) level first in the file, each aligned
    # to lcm(texel block size, 4) under supercompressionScheme 0
    align = _lcm(block_bytes, 4)
    data_start = kvd_ofs + len(kvd)
    offsets = [0] * n_levels
    cursor = data_start
    chunks = []
    for lvl in range(n_levels - 1, -1, -1):
        pad = (-cursor) % align
        chunks.append(b"\x00" * pad)
        cursor += pad
        offsets[lvl] = cursor
        chunks.append(payloads[lvl])
        cursor += len(payloads[lvl])

    level_index = b"".join(
        struct.pack("<3Q", offsets[lvl], len(payloads[lvl]), len(payloads[lvl]))
        for lvl in range(n_levels)
    )

    return b"".join(
        [_IDENTIFIER, header, index, level_index, dfd, kvd, *chunks]
    )
