"""The ETC1S reference of the benchmark.

A file's codebooks and Huffman tables go through the frozen sequential
oracle (`etc1s_oracle.py`); its slices' index streams are decoded here,
vectorised, for the streams the benchmark writes: every Huffman table in
use of one code length, every 2x2 group's endpoint prediction symbol 255
(each block's endpoint a delta from the one before it), no selector
history or runs.  A stream outside that subset raises ReferenceError
rather than being judged.  The benchmark's tests hold this decoder equal
to the oracle's state machine.

Texels follow the reference's RGBA back-end (basis_lz/mod.rs:97-151): the
5-bit colour widened to 8 bits, plus the intensity modifier the selector
picks, clamped to 0..255, alpha 255.  The control (`control=True`) adds
in 8-bit arithmetic that wraps instead of clamping: the guarantee it
breaks is texels equal to the reference decoder's."""

from __future__ import annotations

import numpy as np
import torch

from . import basis_file, etc1s_oracle

MODIFIERS = np.array(etc1s_oracle._ETC1_MODIFIERS, np.int64)  # [inten][selector value]
PRED_ALL_DELTA = 255  # four 2-bit endpoint predictions of 3


def palette(endpoints: np.ndarray, control: bool = False) -> np.ndarray:
    """uint8 [E,4] (r5, g5, b5, inten3) -> uint32 [E,4] RGBA texel words,
    one a selector value."""
    e = np.asarray(endpoints, np.int64).reshape(-1, 4)
    base = (e[:, :3] << 3) | (e[:, :3] >> 2)  # [E,3]
    level = base[:, None, :] + MODIFIERS[e[:, 3]][:, :, None]  # [E,4,3]
    level = level & 0xFF if control else np.clip(level, 0, 255)
    level = level.astype(np.uint32)
    return level[..., 0] | (level[..., 1] << 8) | (level[..., 2] << 16) | np.uint32(0xFF000000)


def selector_values(selectors: np.ndarray) -> np.ndarray:
    """uint8 [S,4] selector row bytes -> uint8 [S,16] selector values, texel
    4y + x at bits 2x of row y (etc.rs:343-394)."""
    rows = np.asarray(selectors, np.uint8).reshape(-1, 4)
    shifts = np.array([2 * x for _y in range(4) for x in range(4)], np.uint8)
    return (rows[:, np.repeat(np.arange(4), 4)] >> shifts) & 3


def texel_words(pal: np.ndarray, selv: np.ndarray, ep, sel, device) -> torch.Tensor:
    """int32 [N,16] texel words (the bits of the uint32 RGBA words) of
    blocks with endpoint indices ep and selector indices sel."""
    pal_t = torch.from_numpy(np.ascontiguousarray(pal).view(np.int32).reshape(-1)).to(device)
    selv_t = torch.from_numpy(selv.astype(np.int64)).to(device)
    ep = torch.as_tensor(ep).to(device=device, dtype=torch.int64)
    sel = torch.as_tensor(sel).to(device=device, dtype=torch.int64)
    return pal_t[ep[:, None] * 4 + selv_t[sel]]


def raster(words: torch.Tensor, nbx: int, nby: int) -> torch.Tensor:
    """int32 [nbx*nby, 16] block texels -> uint8 raster RGBA bytes, rows of
    4 * nbx texels."""
    return words.reshape(nby, nbx, 4, 4).permute(0, 2, 1, 3).contiguous().view(torch.uint8).reshape(-1)


def _fixed_width(table) -> tuple[int, np.ndarray]:
    """(code length, symbol of every code word, -1 where none) of a Huffman
    table all of whose symbols in use have one length."""
    sizes = {size for _sym, size in table.lookup if size}
    if sizes != {table.max_code_size}:
        raise basis_file.ReferenceError("a Huffman table with codes of several lengths")
    return table.max_code_size, np.array([sym if size else -1 for sym, size in table.lookup], np.int64)


def _peek(data: np.ndarray, pos: np.ndarray, width: int) -> np.ndarray:
    """The `width` (<= 16) bits at each bit position, LSB first; bits past
    the end read 0 (bitreader.rs)."""
    i = pos >> 3
    w = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16)
    return (w >> (pos & 7)) & ((1 << width) - 1)


def decode_slice(dec, nbx: int, nby: int, block_data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(endpoint indices, selector indices) of a slice's blocks in raster
    order, as the oracle's decode_blocks gives them."""
    if dec.is_video:
        raise basis_file.ReferenceError("video slices")
    n_ep, n_sel = len(dec.endpoints), len(dec.selectors)
    wp, pred_of = _fixed_width(dec.endpoint_pred_model)
    wd, delta_of = _fixed_width(dec.delta_endpoint_model)
    ws, sel_of = _fixed_width(dec.selector_model)
    n = nbx * nby
    by, bx = np.divmod(np.arange(n, dtype=np.int64), nbx)
    head = ((bx & 1) == 0) & ((by & 1) == 0)
    widths = head * wp + wd + ws
    pos = np.cumsum(widths) - widths
    data = np.frombuffer(bytes(block_data) + bytes(4), np.uint8).astype(np.int64)
    if n and int(pos[-1] + widths[-1]) > 8 * len(block_data) + 8:
        raise basis_file.ReferenceError("slice payload shorter than its blocks")
    if (pred_of[_peek(data, pos[head], wp)] != PRED_ALL_DELTA).any():
        raise basis_file.ReferenceError("endpoint predictions other than a delta")
    dpos = pos + head * wp
    delta = delta_of[_peek(data, dpos, wd)]
    sel = sel_of[_peek(data, dpos + wd, ws)]
    if (delta < 0).any() or (delta >= n_ep).any():
        raise basis_file.ReferenceError("endpoint delta outside the codebook")
    if (sel < 0).any() or (sel >= n_sel).any():
        raise basis_file.ReferenceError("selector history or run codes")
    return (np.cumsum(delta) % n_ep).astype(np.uint16), sel.astype(np.uint16)


def decoder(buf: bytes):
    """(header, slice descriptors, oracle decoder) of a checked ETC1S file."""
    header, descs = basis_file.parse(buf)
    if header["tex_format"] != basis_file.FORMAT_ETC1S:
        raise basis_file.ReferenceError("not an ETC1S file")
    return header, descs, etc1s_oracle.oracle_make_decoder(buf)


def codebooks(dec) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 [E,4] endpoints, uint8 [S,4] selector rows) of an oracle
    decoder."""
    ep = np.array([list(c) + [i] for c, i in dec.endpoints], np.uint8).reshape(-1, 4)
    sel = np.array([s.rows for s in dec.selectors], np.uint8).reshape(-1, 4)
    return ep, sel


def file_rgba_images(buf: bytes, device, control: bool = False) -> list[dict]:
    """The images read_to_rgba of an ETC1S file without alpha slices should
    give, one a slice: {w, h, data (uint8 raster RGBA bytes on device)}."""
    header, descs, dec = decoder(buf)
    if header["flags"] & basis_file.FLAG_HAS_ALPHA:
        raise basis_file.ReferenceError("alpha slices")
    endpoints, selectors = codebooks(dec)
    pal, selv = palette(endpoints, control), selector_values(selectors)
    images = []
    for d in descs:
        ep, sel = decode_slice(dec, d["nbx"], d["nby"], basis_file.payload(buf, d))
        words = texel_words(pal, selv, ep, sel, device)
        images.append({"w": d["orig_width"], "h": d["orig_height"], "data": raster(words, d["nbx"], d["nby"])})
    return images
