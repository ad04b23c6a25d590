"""The UASTC reference of the benchmark: each distinct block through the
frozen sequential oracle (`uastc_oracle.py`), then a gather over the
batch.  Every UASTC input the benchmark makes is drawn from the 608
golden blocks, so a batch of millions of blocks costs the oracle 608
calls; a block outside that set goes through the oracle too.

The control (`control=True`) is this reference with the one float32 step
of the transcode, BC7's p-bit search, computed in bfloat16: the
guarantee it breaks is bytes equal to the reference transcoder's."""

from __future__ import annotations

import numpy as np

from . import basis_file, uastc_oracle

OUT_BYTES = {"bc7": 16}


def bf16(x):
    """x (a numpy float32) rounded to the nearest bfloat16, ties to even."""
    bits = int(np.float32(x).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return np.uint32(bits).view(np.float32)


def _convert(block: bytes, target: str, control: bool) -> bytes:
    if target != "bc7":
        raise ValueError(f"no reference for target {target!r}")
    if control:
        return uastc_oracle.convert_block_to_bc7(block, rnd=bf16)
    return uastc_oracle.convert_block_to_bc7(block)


def block_table(blocks: np.ndarray, target: str, control: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """uint8 [K,16] blocks -> (uint8 [K, OUT_BYTES[target]] outputs, bool
    [K] errors); an invalid block's output row is zero."""
    out = np.zeros((len(blocks), OUT_BYTES[target]), np.uint8)
    err = np.zeros(len(blocks), bool)
    for k, b in enumerate(np.asarray(blocks, np.uint8)):
        try:
            out[k] = np.frombuffer(_convert(b.tobytes(), target, control), np.uint8)
        except uastc_oracle.OracleUastcError:
            err[k] = True
    return out, err


def _keys(blocks: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(blocks, np.uint8).view(np.uint64).reshape(-1, 2)
    return w[:, 0] ^ (w[:, 1] * np.uint64(0x9E3779B97F4A7C15))


def table_index(blocks: np.ndarray, known: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows, index): rows is `known` followed by every distinct block of
    `blocks` that is not in it, and rows[index[i]] == blocks[i]."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    rows = np.unique(np.ascontiguousarray(known, np.uint8).reshape(-1, 16), axis=0)
    keys = _keys(rows)
    order = np.argsort(keys, kind="stable")
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("colliding keys among the known blocks")
    bk = _keys(blocks)
    pos = np.minimum(np.searchsorted(keys[order], bk), len(keys) - 1)
    index = order[pos]
    hit = (rows[index] == blocks).all(axis=1)
    if not hit.all():
        extra, inverse = np.unique(blocks[~hit], axis=0, return_inverse=True)
        index = index.copy()
        index[~hit] = len(rows) + inverse.reshape(-1)
        rows = np.concatenate([rows, extra])
    return rows, index


def file_images(buf: bytes, target: str, known: np.ndarray, control: bool = False, cache=None) -> list[dict]:
    """The images read_to_<target> of a UASTC file should give: one a
    slice, {w, h, data (uint8 block bytes in slice order), err (bool a
    block)}.  Raises basis_file.ReferenceError where the reference
    refuses the file.  cache (a dict) keeps block_table's results between
    files of one set of distinct blocks."""
    header, descs = basis_file.parse(buf)
    if header["tex_format"] != basis_file.FORMAT_UASTC:
        raise basis_file.ReferenceError("not a UASTC file")
    parts = []
    for d in descs:
        data = basis_file.payload(buf, d)
        if len(data) % 16 or len(data) // 16 != d["nbx"] * d["nby"]:
            raise basis_file.ReferenceError("slice size is not its blocks")
        parts.append(np.frombuffer(data, np.uint8).reshape(-1, 16))
    blocks = np.concatenate(parts) if parts else np.zeros((0, 16), np.uint8)
    rows, index = table_index(blocks, known)
    key = (target, control, rows.tobytes())
    if cache is None or key not in cache:
        table = block_table(rows, target, control)
        if cache is None:
            cache = {}
        cache[key] = table
    out, err = cache[key]
    images, start = [], 0
    for d, p in zip(descs, parts):
        idx = index[start : start + len(p)]
        images.append({"w": d["orig_width"], "h": d["orig_height"], "data": out[idx].reshape(-1), "err": err[idx]})
        start += len(p)
    return images
