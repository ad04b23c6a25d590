"""The .basis container and the UASTC file path of the port."""

from .basis import (
    Header,
    SliceDesc,
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
    "read_header",
    "read_slice_descs",
    "read_to_astc",
    "read_to_bc7",
    "read_to_etc1",
    "read_to_etc2",
    "read_to_rgba",
    "read_to_uastc",
]
