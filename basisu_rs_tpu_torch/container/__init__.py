"""The .basis container and the file paths of the port (UASTC and ETC1S)."""

from .basis import (
    Header,
    SliceDesc,
    make_etc1s_decoder,
    read_header,
    read_slice_descs,
    read_to_astc,
    read_to_bc7,
    read_to_etc1,
    read_to_etc2,
    read_to_rgba,
    read_to_uastc,
)

__all__ = [
    "Header",
    "SliceDesc",
    "make_etc1s_decoder",
    "read_header",
    "read_slice_descs",
    "read_to_astc",
    "read_to_bc7",
    "read_to_etc1",
    "read_to_etc2",
    "read_to_rgba",
    "read_to_uastc",
]
