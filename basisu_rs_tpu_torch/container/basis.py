""".basis container parsing and the file paths of both source formats.

Port of `basisu_rs_tpu/container/basis.py`, mirroring the reference
container layer (src/basis.rs): signature + 77-byte header with u24
fields, CRC-16/GENIBUS header and data checksums, 23-byte slice
descriptors, and `read_to_{rgba,astc,bc7,etc1,etc2,uastc}`.

Device design.  The host parses and checks the file (header, both CRCs,
slice table).  Every reader but `read_to_uastc` runs its device work over
a mesh (`parallel/mesh.py`): `mesh=` (a device list, `parallel.make_mesh`),
or the one device `device` names when no mesh is given; when both are
given, the mesh decides.  A UASTC file's payload of all slices, in slice
order, splits contiguously over the mesh and goes from the host straight
to each shard's device, once; each shard pays one launch for BC7, or one
partition and at most 19 launches for another target
(`parallel.sharded_transcode`), not that per slice, and the first
failing block in slice order is the reference's abort point.  An ETC1S
file's slices go through the host front-end (C++, `etc1s_frontend.py`) one
by one, in the reference's order, into one host array of uint16 index
streams; those split over the mesh the same way and are decoded by one
kernel launch a shard (K6, K8 when the file has alpha slices, K9 for
ETC1; `parallel.sharded_etc1s_transcode`), since the codebooks are the
file's.  Images are built on mesh[0]; RGBA images are reordered from block
rows ([by, bx, y, x]) to raster rows there.  Images keep the JAX package's
strides.  Every `read_to_*` runs on `device="cuda"` unless asked for
another device or a mesh.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

from ..base import BasisError, Image, host_tensor, to_device
from ..ops.dispatch import raise_block_error
from ..parallel.mesh import resolve_mesh, sharded_etc1s_transcode, sharded_transcode
from ..tables import UASTC_BLOCK_SIZE
from ..utils.profiling import count, span
from .crc import crc16
from .etc1s_frontend import Etc1sDecoder

SIG = 0x4273


class TextureType(IntEnum):
    Type2D = 0
    Type2DArray = 1
    CubemapArray = 2
    VideoFrames = 3
    Volume = 4


class TexFormat(IntEnum):
    ETC1S = 0
    UASTC4x4 = 1


class HeaderFlags(IntEnum):
    ETC1S = 1
    YFlipped = 2
    HasAlphaSlices = 4


class SliceDescFlags(IntEnum):
    HasAlpha = 1
    FrameIsIFrame = 2


def _u24(b: bytes, ofs: int) -> int:
    return b[ofs] | (b[ofs + 1] << 8) | (b[ofs + 2] << 16)


@dataclass
class Header:
    """77-byte .basis file header (reference: basis.rs:417-517)."""

    FILE_SIZE = 77

    sig: int
    ver: int
    header_size: int
    header_crc16: int
    data_size: int
    data_crc16: int
    total_slices: int
    total_images: int
    tex_format: int
    flags: int
    tex_type: int
    us_per_frame: int
    reserved: int
    userdata0: int
    userdata1: int
    total_endpoints: int
    endpoint_cb_file_ofs: int
    endpoint_cb_file_size: int
    total_selectors: int
    selector_cb_file_ofs: int
    selector_cb_file_size: int
    tables_file_ofs: int
    tables_file_size: int
    slice_desc_file_ofs: int
    extended_file_ofs: int
    extended_file_size: int

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & HeaderFlags.HasAlphaSlices)

    @property
    def has_y_flipped(self) -> bool:
        return bool(self.flags & HeaderFlags.YFlipped)

    def texture_format(self) -> TexFormat:
        try:
            return TexFormat(self.tex_format)
        except ValueError:
            raise BasisError("Unknown texture format") from None

    @classmethod
    def from_file_bytes(cls, b: bytes) -> "Header":
        assert len(b) >= cls.FILE_SIZE
        sig, ver, header_size, header_crc = struct.unpack_from("<4H", b, 0)
        (data_size,) = struct.unpack_from("<I", b, 8)
        (data_crc,) = struct.unpack_from("<H", b, 12)
        total_slices = _u24(b, 14)
        total_images = _u24(b, 17)
        tex_format = b[20]
        (flags,) = struct.unpack_from("<H", b, 21)
        tex_type = b[23]
        us_per_frame = _u24(b, 24)
        reserved, ud0, ud1 = struct.unpack_from("<3I", b, 27)
        (total_endpoints, endpoint_ofs) = struct.unpack_from("<HI", b, 39)
        endpoint_size = _u24(b, 45)
        (total_selectors, selector_ofs) = struct.unpack_from("<HI", b, 48)
        selector_size = _u24(b, 54)
        tables_ofs, tables_size, slice_ofs, ext_ofs, ext_size = struct.unpack_from("<5I", b, 57)
        return cls(
            sig, ver, header_size, header_crc, data_size, data_crc, total_slices,
            total_images, tex_format, flags, tex_type, us_per_frame, reserved, ud0,
            ud1, total_endpoints, endpoint_ofs, endpoint_size, total_selectors,
            selector_ofs, selector_size, tables_ofs, tables_size, slice_ofs,
            ext_ofs, ext_size,
        )


@dataclass
class SliceDesc:
    """23-byte slice descriptor (reference: basis.rs:519-572)."""

    FILE_SIZE = 23

    image_index: int
    level_index: int
    flags: int
    orig_width: int
    orig_height: int
    num_blocks_x: int
    num_blocks_y: int
    file_ofs: int
    file_size: int
    slice_data_crc16: int

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & SliceDescFlags.HasAlpha)

    def data(self, buf) -> memoryview:
        """The slice's payload bytes, a view of buf (clipped at its end as
        Python slicing clips)."""
        return _section(buf, self.file_ofs, self.file_size)

    @classmethod
    def from_file_bytes(cls, b: bytes) -> "SliceDesc":
        assert len(b) >= cls.FILE_SIZE
        image_index = _u24(b, 0)
        level_index, flags = b[3], b[4]
        ow, oh, nbx, nby = struct.unpack_from("<4H", b, 5)
        fo, fs = struct.unpack_from("<2I", b, 13)
        (crc,) = struct.unpack_from("<H", b, 21)
        return cls(image_index, level_index, flags, ow, oh, nbx, nby, fo, fs, crc)


def read_header(buf: bytes) -> Header:
    """Parse + validate the header (reference: basis.rs:307-336)."""
    if len(buf) < 2 or struct.unpack_from("<H", buf, 0)[0] != SIG:
        raise BasisError("Sig mismatch, not a Basis Universal file")
    if len(buf) < Header.FILE_SIZE:
        raise BasisError(f"Expected at least {Header.FILE_SIZE} byte header, got {len(buf)} bytes")
    header = Header.from_file_bytes(buf)
    if header.header_size != Header.FILE_SIZE:
        raise BasisError(
            f"File specified unexpected header size, expected {Header.FILE_SIZE}, "
            f"got {header.header_size}"
        )
    if crc16(memoryview(buf)[8 : Header.FILE_SIZE]) != header.header_crc16:
        raise BasisError("Header CRC16 failed")
    return header


def check_file_checksum(buf: bytes, header: Header) -> bool:
    return crc16(memoryview(buf)[Header.FILE_SIZE :]) == header.data_crc16


def read_slice_descs(buf: bytes, header: Header) -> list[SliceDesc]:
    start = header.slice_desc_file_ofs
    descs = []
    for i in range(header.total_slices):
        ofs = start + i * SliceDesc.FILE_SIZE
        if len(buf) - ofs < SliceDesc.FILE_SIZE:
            raise BasisError(
                f"Expected {SliceDesc.FILE_SIZE} byte slice desc at pos {ofs}, "
                f"only {len(buf) - ofs} bytes remain"
            )
        descs.append(SliceDesc.from_file_bytes(buf[ofs : ofs + SliceDesc.FILE_SIZE]))
    return descs


def _validated(buf: bytes) -> tuple[Header, list[SliceDesc]]:
    with span("container.validate"):
        header = read_header(buf)
        if not check_file_checksum(buf, header):
            raise BasisError("Data CRC16 failed")
        return header, read_slice_descs(buf, header)


def _slice_span(buf: bytes, desc: SliceDesc) -> tuple[int, int]:
    """(start, size) of the slice's payload in the file, clipped at its end
    as Python slicing clips."""
    start = min(desc.file_ofs, len(buf))
    return start, min(desc.file_size, len(buf) - start)


def _view(buf: bytes, span: tuple[int, int]) -> np.ndarray:
    """Read-only uint8 view of buf[start : start + size]."""
    start, size = span
    return np.frombuffer(buf, np.uint8, count=size, offset=start)


def uastc_host_payload(buf: bytes, descs: list[SliceDesc]) -> tuple[torch.Tensor, list[int]]:
    """(blocks, counts): the UASTC blocks of the slices before the first one
    whose payload is not a whole number of blocks (all slices when every one
    is), concatenated in slice order as a uint8 [N,16] CPU tensor (a view
    of buf when those slices lie back to back in it); counts holds each of
    those slices' block count."""
    with span("container.payload"):
        spans = []
        for desc in descs:
            start, size = _slice_span(buf, desc)
            if size % UASTC_BLOCK_SIZE:
                break
            spans.append((start, size))
        if spans and all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:])):
            # slices back to back in the file: one view, no host copy
            host = _view(buf, (spans[0][0], sum(n for _, n in spans)))
        else:
            host = np.concatenate([np.zeros(0, np.uint8)] + [_view(buf, part) for part in spans])
        return host_tensor(host).reshape(-1, UASTC_BLOCK_SIZE), [n // UASTC_BLOCK_SIZE for _, n in spans]


def _check_errs(err: torch.Tensor, blocks: torch.Tensor) -> None:
    """Raise with the reference's message for the FIRST failing block.

    The reference's transcode loop (uastc.rs:148-165) aborts read_to_* with
    the first failing block's own error (ops.dispatch.raise_block_error).
    The kernels report a flag per block in block order (blocks may lie on
    another device than err).  Span: `container.error_check`, the wait for
    the flags."""
    with span("container.error_check"):
        count("host_syncs")
        bad = torch.nonzero(err)
        if bad.numel():
            count("host_syncs", 2)
            first = int(bad[0, 0])
            raise_block_error(blocks[first : first + 1])


def _uastc_file(buf: bytes, descs: list[SliceDesc], target: str, mesh: tuple):
    """(slices, out) of a UASTC file: out is sharded_transcode's result
    over every slice in slice order, on mesh[0], and slices holds (desc,
    first row, end row) of each slice's rows in out."""
    blocks, counts = uastc_host_payload(buf, descs)
    out, err = sharded_transcode(blocks, target, mesh)
    _check_errs(err, blocks)
    if len(counts) < len(descs):
        raise BasisError("data length is not divisible by UASTC block size (16)")
    ends = np.cumsum(counts).tolist()
    return [(d, e - n, e) for d, n, e in zip(descs, counts, ends)], out


def rgba_images(out: torch.Tensor, slices) -> list[Image]:
    """Per-slice RGBA byte images from [N,16] packed RGBA texel words over
    the file's blocks: [by, bx, y, x] texel rows -> raster rows, on the
    device.  Span: `container.images`."""
    with span("container.images"):
        texels = out.view(torch.uint8)  # [N, 64]: 4 rows of 4 texels of 4 bytes
        images = []
        for desc, a, b in slices:
            nbx = desc.num_blocks_x
            t = texels[a:b].reshape(-1, nbx, 4, 16).permute(0, 2, 1, 3).reshape(-1)
            images.append(Image(w=desc.orig_width, h=desc.orig_height, stride=4 * nbx * 4, data=t))
        return images


def _block_images(out: torch.Tensor, slices) -> list[Image]:
    """One image of out's block rows per slice, a row of blocks per stride.
    Span: `container.images`."""
    with span("container.images"):
        rows = out.view(torch.uint8)
        size = rows.shape[1]
        return [
            Image(w=desc.orig_width, h=desc.orig_height, stride=size * desc.num_blocks_x, data=rows[a:b].reshape(-1))
            for desc, a, b in slices
        ]


# ---------------------------------------------------------------------------
# ETC1S files
# ---------------------------------------------------------------------------


def _section(buf, ofs: int, size: int) -> memoryview:
    """buf[ofs : ofs + size] without a copy, clipped as Python slicing clips."""
    return memoryview(buf)[ofs : ofs + size]


def make_etc1s_decoder(header: Header, buf, *, endpoint_count_quirk: bool = False, native: bool = True) -> Etc1sDecoder:
    """The BasisLZ decoder of a file, from its header-addressed byte ranges
    (reference: basis.rs:262-298).

    The reference passes `total_selectors` as the endpoint count
    (basis.rs:290, a latent quirk); by default this uses `total_endpoints`,
    which files from the official encoder need.  endpoint_count_quirk=True
    gives the reference's behaviour on files where the counts differ
    (COMPAT.md item 1).  native=False runs the plain Python front-end."""
    n_endpoints = header.total_selectors if endpoint_count_quirk else header.total_endpoints
    return Etc1sDecoder(
        n_endpoints,
        header.total_selectors,
        _section(buf, header.endpoint_cb_file_ofs, header.endpoint_cb_file_size),
        _section(buf, header.selector_cb_file_ofs, header.selector_cb_file_size),
        _section(buf, header.tables_file_ofs, header.tables_file_size),
        is_video=header.tex_type == TextureType.VideoFrames,
        native=native,
    )


def etc1s_index_streams(buf, dec: Etc1sDecoder, descs: list[SliceDesc], pairs: bool):
    """Run the front-end over the file's slices in the reference's order,
    into one host array of index streams.

    pairs=True (read_to_rgba of a file with alpha slices): descs go in
    (RGB, alpha) pairs, each alpha slice decoded before its RGB slice, and
    the array has 4 rows (endpoint, selector, alpha endpoint, alpha
    selector) over the RGB slices' blocks; otherwise 2 rows over every
    slice's blocks.  Returns (uint16 [rows, N], slices: (desc, first, end)
    of each image's blocks).  Span: `frontend.slice` around each slice's
    decode."""
    step = 2 if pairs else 1
    image_descs = descs[::step]
    ends = np.cumsum([0] + [d.num_blocks_x * d.num_blocks_y for d in image_descs]).tolist()
    slices = list(zip(image_descs, ends, ends[1:]))
    host = np.empty((2 * step, ends[-1]), np.uint16)
    for k, (desc, a, b) in enumerate(slices):
        if pairs:
            alpha_desc = descs[2 * k + 1]
            if not alpha_desc.has_alpha:
                raise BasisError("Expected slice with alpha")
            if (alpha_desc.num_blocks_x, alpha_desc.num_blocks_y) != (desc.num_blocks_x, desc.num_blocks_y):
                raise BasisError("RGB slice and Alpha slice have different dimensions")
            with span("frontend.slice"):
                dec.decode_slice(alpha_desc.num_blocks_x, alpha_desc.num_blocks_y, alpha_desc.data(buf),
                                 out=(host[2, a:b], host[3, a:b]))
        with span("frontend.slice"):
            dec.decode_slice(desc.num_blocks_x, desc.num_blocks_y, desc.data(buf), out=(host[0, a:b], host[1, a:b]))
    return host, slices


def _etc1s_indices(buf, header: Header, descs: list[SliceDesc], pairs: bool):
    """(decoder, host index streams, slices) of an ETC1S file
    (etc1s_index_streams).  Span: `frontend.decode`, the decoder's build
    and every slice."""
    if header.has_alpha and header.total_slices % 2 != 0:
        raise BasisError("File has alpha, but slice count is odd")
    with span("frontend.decode"):
        dec = make_etc1s_decoder(header, buf)
        host, slices = etc1s_index_streams(buf, dec, descs, pairs)
    return dec, torch.from_numpy(host), slices


def _etc1s_rgba(buf, header: Header, descs: list[SliceDesc], mesh: tuple):
    """(slices, texels) of an ETC1S file: one K6 launch a shard, or one K8
    launch a shard when the file has alpha slices (reference:
    basis.rs:26-53)."""
    dec, idx, slices = _etc1s_indices(buf, header, descs, header.has_alpha)
    kind, alpha_pass = ("rgba_alpha", (idx[2], idx[3])) if header.has_alpha else ("rgba", ())
    # the front-end checked every index against its codebook
    out = sharded_etc1s_transcode(kind, dec.endpoints, dec.selectors, idx[0], idx[1], mesh, extra_idx=alpha_pass,
                                  check_index=False)
    return slices, out


def _etc1s_etc1(buf, header: Header, descs: list[SliceDesc], mesh: tuple):
    """(slices, blocks) of an ETC1S file: one K9 launch a shard over every
    slice."""
    dec, idx, slices = _etc1s_indices(buf, header, descs, False)
    # the front-end checked every index against its codebook
    return slices, sharded_etc1s_transcode("etc1", dec.endpoints, dec.selectors, idx[0], idx[1], mesh,
                                           check_index=False)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def _open(buf: bytes, device, mesh=None):
    """(mesh, header, slice descriptors, texture format) of a checked file;
    the mesh is resolve_mesh(device, mesh)."""
    mesh = resolve_mesh(device, mesh)
    header, descs = _validated(buf)
    return mesh, header, descs, header.texture_format()


def read_to_rgba(buf: bytes, device="cuda", mesh=None) -> tuple[Header, list[Image]]:
    """-> (Header, [Image]) of RGBA bytes, one image per slice, or per
    (RGB, alpha) slice pair of an ETC1S file with alpha (reference:
    basis.rs:8-90).  Rows of an image are 4 * num_blocks_x texels apart
    (COMPAT.md item 2).  mesh: a device list to shard the device work
    over (module docstring); None runs on `device`."""
    with span("container.read"):
        mesh, header, descs, fmt = _open(buf, device, mesh)
        if fmt == TexFormat.ETC1S:
            slices, out = _etc1s_rgba(buf, header, descs, mesh)
        else:
            slices, out = _uastc_file(buf, descs, "rgba", mesh)
        return header, rgba_images(out, slices)


def _read_to_blocks(buf: bytes, target: str, device, mesh) -> list[Image]:
    """Shared UASTC path of read_to_{astc,bc7,etc2} (basis.rs:92-260): one
    image of `target` blocks per slice.  An ETC1S file is
    refused (COMPAT.md item 3)."""
    with span("container.read"):
        mesh, header, descs, fmt = _open(buf, device, mesh)
        if fmt != TexFormat.UASTC4x4:
            raise BasisError("unsupported texture format")
        slices, out = _uastc_file(buf, descs, target, mesh)
        return _block_images(out, slices)


def read_to_astc(buf: bytes, device="cuda", mesh=None) -> list[Image]:
    return _read_to_blocks(buf, "astc", device, mesh)


def read_to_bc7(buf: bytes, device="cuda", mesh=None) -> list[Image]:
    return _read_to_blocks(buf, "bc7", device, mesh)


def read_to_etc1(buf: bytes, device="cuda", mesh=None) -> list[Image]:
    """8-byte ETC1 blocks, one image per slice, of a UASTC or an ETC1S file."""
    with span("container.read"):
        mesh, header, descs, fmt = _open(buf, device, mesh)
        if fmt == TexFormat.ETC1S:
            slices, out = _etc1s_etc1(buf, header, descs, mesh)
        else:
            slices, out = _uastc_file(buf, descs, "etc1", mesh)
        return _block_images(out, slices)


def read_to_etc2(buf: bytes, device="cuda", mesh=None) -> list[Image]:
    """16-byte ETC2 RGBA blocks (EAC alpha, then ETC1) of a UASTC file; an
    ETC1S file is refused, as in the reference."""
    return _read_to_blocks(buf, "etc2", device, mesh)


def read_to_uastc(buf: bytes, device="cuda") -> list[Image]:
    """Raw UASTC block passthrough (reference: basis.rs:175-202), the
    payload of each slice copied to `device`."""
    with span("container.read"):
        (device,), header, descs, fmt = _open(buf, device)
        if fmt != TexFormat.UASTC4x4:
            raise BasisError("unsupported texture format")
        return [
            Image(
                w=desc.orig_width,
                h=desc.orig_height,
                stride=UASTC_BLOCK_SIZE * desc.num_blocks_x,
                data=_payload_copy(_view(buf, _slice_span(buf, desc)), device),
            )
            for desc in descs
        ]


def _payload_copy(host: np.ndarray, device) -> torch.Tensor:
    """A copy of host bytes on `device` (to_device's), a copy on the CPU
    too, so that no image holds memory of the caller's bytes."""
    t = to_device(host_tensor(host), device)
    return t.clone() if device.type == "cpu" else t
