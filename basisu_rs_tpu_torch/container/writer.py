""".basis file writer: synthetic UASTC and ETC1S files for tests and
`chip_smoke.py`.

Port of `basisu_rs_tpu/container/writer.py`, byte for byte the JAX
package's writer's output.  The ETC1S encoder is simple but conformant for
the decoder's subset: equal-length canonical Huffman codes, raw selector
codebooks, pred-3 (DPCM) endpoint coding for every block and no selector
history (`write_etc1s_basis`), or a randomised stream that drives every
path of the decoder's state machine (`write_etc1s_basis_fuzz`).

`write_etc1s_basis` packs its fixed-width slice payloads with numpy
(`_pack_fields`) rather than one `BitWriterLsb.write` a symbol, so that a
file of 2^23 blocks is written in seconds; a test holds its bytes equal to
the JAX writer's.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..utils.bitio import BitWriterLsb
from .crc import crc16
from .huffman import CODELENGTH_INDICES, MAX_SUPPORTED_CODE_SIZE


class CanonicalEncoder:
    """Canonical Huffman encoder matching the decoder's code assignment
    (bit-reversed LSB-first codes)."""

    def __init__(self, code_sizes):
        sizes = list(code_sizes)
        counts = [0] * (MAX_SUPPORTED_CODE_SIZE + 1)
        for s in sizes:
            counts[s] += 1
        counts[0] = 0
        next_code = [0] * (MAX_SUPPORTED_CODE_SIZE + 1)
        total = 0
        for bits in range(1, MAX_SUPPORTED_CODE_SIZE + 1):
            total = (total + counts[bits - 1]) << 1
            next_code[bits] = total
        self.codes = {}
        self.sizes = sizes
        for sym, size in enumerate(sizes):
            if size == 0:
                continue
            code = next_code[size]
            next_code[size] += 1
            rev = int(f"{code:0{size}b}"[::-1], 2)
            self.codes[sym] = (rev, size)

    def encode(self, w: BitWriterLsb, sym: int) -> None:
        code, size = self.codes[sym]
        w.write(size, code)

    def code_table(self) -> tuple[np.ndarray, np.ndarray]:
        """(code, size) of every symbol as uint64 arrays (0, 0 where unused)."""
        n = len(self.sizes)
        code, size = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
        for sym, (c, s) in self.codes.items():
            code[sym], size[sym] = c, s
        return code, size


def equal_length_sizes(num_symbols: int) -> list[int]:
    """All `num_symbols` symbols get the same (Kraft-valid) code length."""
    if num_symbols == 1:
        return [1]
    bits = max(1, math.ceil(math.log2(num_symbols)))
    return [bits] * num_symbols


def write_huffman_table(w: BitWriterLsb, code_sizes) -> CanonicalEncoder:
    """Emit a table definition the decoder's `read_huffman_table` accepts:
    every symbol's length spelled out (no RLE), 5-bit meta-codes."""
    sizes = list(code_sizes)
    w.write(14, len(sizes))
    # meta table: the length values in use (and nothing else), all at size 5
    used = sorted(set(sizes))
    assert all(0 <= v <= 16 for v in used)
    meta_sizes = [0] * 21
    for v in used:
        meta_sizes[v] = 5
    meta = CanonicalEncoder(meta_sizes)
    w.write(5, 21)
    for idx in CODELENGTH_INDICES:
        w.write(3, meta_sizes[idx] & 7)
    for v in sizes:
        meta.encode(w, v)
    return CanonicalEncoder(sizes)


# ---------------------------------------------------------------------------
# container assembly
# ---------------------------------------------------------------------------


def _pack_header(
    *,
    data_size: int,
    data_crc16: int,
    total_slices: int,
    total_images: int,
    tex_format: int,
    flags: int,
    tex_type: int,
    total_endpoints: int = 0,
    endpoint_ofs: int = 0,
    endpoint_size: int = 0,
    total_selectors: int = 0,
    selector_ofs: int = 0,
    selector_size: int = 0,
    tables_ofs: int = 0,
    tables_size: int = 0,
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
    # us_per_frame, reserved and userdata (bytes 24..39) stay zero
    struct.pack_into("<HI", b, 39, total_endpoints, endpoint_ofs)
    b[45:48] = endpoint_size.to_bytes(3, "little")
    struct.pack_into("<HI", b, 48, total_selectors, selector_ofs)
    b[54:57] = selector_size.to_bytes(3, "little")
    struct.pack_into("<5I", b, 57, tables_ofs, tables_size, slice_desc_ofs, 0, 0)
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


# ---------------------------------------------------------------------------
# ETC1S
# ---------------------------------------------------------------------------


def encode_etc1s_endpoint_codebook(endpoints: np.ndarray) -> bytes:
    """endpoints: uint8 [E,4] (r5,g5,b5,inten3) -> codebook byte stream
    (inverse of etc1s_frontend.decode_endpoints)."""
    w = BitWriterLsb()
    color_enc = [write_huffman_table(w, equal_length_sizes(32)) for _ in range(3)]
    inten_enc = write_huffman_table(w, equal_length_sizes(8))
    w.write(1, 0)  # grayscale = false

    prev_color5 = [16, 16, 16]
    prev_inten = 0
    for e in endpoints:
        inten_delta = (int(e[3]) - prev_inten) & 7
        inten_enc.encode(w, inten_delta)
        prev_inten = int(e[3])
        for c in range(3):
            p = prev_color5[c]
            model = color_enc[0 if p <= 9 else (1 if p <= 21 else 2)]
            delta = (int(e[c]) - p) & 31
            model.encode(w, delta)
            prev_color5[c] = int(e[c])
    return w.getvalue()


def encode_etc1s_selector_codebook(selectors: np.ndarray) -> bytes:
    """selectors: uint8 [S,4] row bytes -> raw codebook stream."""
    w = BitWriterLsb()
    w.write(1, 0)  # global
    w.write(1, 0)  # hybrid
    w.write(1, 1)  # raw
    for s in selectors:
        for y in range(4):
            w.write(8, int(s[y]))
    return w.getvalue()


class Etc1sSliceFuzzEncoder:
    """Randomised ETC1S slice encoder that drives the decoder's whole state
    machine: endpoint predictors 0-3 (with the per-position legality rules),
    endpoint-pred RLE + VLC, the selector history buffer with approximate
    move-to-front, selector RLE runs, and the texture-video prev-frame path.

    It simulates the decoder while encoding, so the expected (endpoint,
    selector) index streams fall out by construction (mod.rs:188-458 is the
    contract being fuzzed).
    """

    def __init__(self, num_endpoints, num_selectors, hist_size, rng, is_video=False):
        self.E = num_endpoints
        self.S = num_selectors
        self.H = hist_size
        self.rng = rng
        self.is_video = is_video

    def encode_slice(self, w: BitWriterLsb, pred_enc, delta_enc, sel_enc, rle_enc, nbx, nby):
        """Returns the (ep_idx, sel_idx) uint16 arrays the decoder must produce."""
        rng = self.rng
        E, S, H = self.E, self.S, self.H
        ep_out = np.zeros(nbx * nby, np.uint16)
        sel_out = np.zeros(nbx * nby, np.uint16)

        pred_rows = np.zeros((2, nbx), np.uint8)
        pred_ep_rows = np.zeros((2, nbx), np.uint16)
        prev_ep = 0
        hist = [0] * H
        rover = H // 2
        sel_rle_left = 0
        if self.is_video:
            prev_frame = np.zeros((nbx * nby, 2), np.uint16)

        def pick_pred(bx, by):
            opts = [3]
            if bx > 0:
                opts.append(0)
            if by > 0:
                opts.append(1)
            if (bx > 0 and by > 0) or self.is_video:
                opts.append(2)
            return int(rng.choice(opts))

        bi = 0
        for by in range(nby):
            cur = by & 1
            for bx in range(nbx):
                if bx & 1 == 0:
                    if by & 1 == 0:
                        # the preds of the 2x2 group, in one symbol
                        p00 = pick_pred(bx, by)
                        p10 = pick_pred(bx + 1, by) if bx + 1 < nbx else 3
                        p01 = pick_pred(bx, by + 1) if by + 1 < nby else 3
                        p11 = pick_pred(bx + 1, by + 1) if bx + 1 < nbx and by + 1 < nby else 3
                        sym = p00 | (p10 << 2) | (p01 << 4) | (p11 << 6)
                        pred_enc.encode(w, sym)
                        cur_pred_bits = sym
                        pred_rows[cur ^ 1, bx] = sym >> 4
                    else:
                        cur_pred_bits = int(pred_rows[cur, bx])

                pred = cur_pred_bits & 3
                cur_pred_bits >>= 2

                if pred == 0:
                    ep = prev_ep
                elif pred == 1:
                    ep = int(pred_ep_rows[cur ^ 1, bx])
                elif pred == 2:
                    if self.is_video:
                        ep = int(prev_frame[bi, 0])
                    else:
                        ep = int(pred_ep_rows[cur ^ 1, bx - 1])
                else:
                    ep = int(rng.integers(0, E))
                    delta = (ep - prev_ep) % E
                    delta_enc.encode(w, delta)

                pred_ep_rows[cur, bx] = ep
                prev_ep = ep

                if not self.is_video or pred != 2:
                    if sel_rle_left > 0:
                        sel_rle_left -= 1
                        sel = hist[0]
                    else:
                        action = rng.random()
                        if H > 0 and action < 0.2:
                            # history reference
                            j = int(rng.integers(0, H))
                            sel_enc.encode(w, S + j)
                            sel = hist[j]
                            if j > 0:
                                hist[j // 2], hist[j] = hist[j], hist[j // 2]
                        elif H > 0 and action < 0.3:
                            # RLE run of hist[0]
                            count = int(rng.integers(3, 80))
                            sel_enc.encode(w, S + H)
                            run_sym = count - 3
                            if run_sym >= 63:
                                rle_enc.encode(w, 63)
                                _write_vlc(w, count - 3, 7)
                            else:
                                rle_enc.encode(w, run_sym)
                            sel_rle_left = count - 1
                            sel = hist[0]
                        else:
                            sel = int(rng.integers(0, S))
                            sel_enc.encode(w, sel)
                            if H > 0:
                                hist[rover] = sel
                                rover += 1
                                if rover == H:
                                    rover = H // 2
                else:
                    sel = int(prev_frame[bi, 1])

                if self.is_video:
                    prev_frame[bi, 0] = ep
                    prev_frame[bi, 1] = sel

                ep_out[bi] = ep
                sel_out[bi] = sel
                bi += 1

        return ep_out, sel_out


def _write_vlc(w: BitWriterLsb, v: int, chunk_bits: int) -> None:
    """Inverse of decode_vlc (mod.rs:585-608)."""
    chunk_mask = (1 << chunk_bits) - 1
    while True:
        chunk = v & chunk_mask
        v >>= chunk_bits
        if v:
            w.write(chunk_bits + 1, chunk | (1 << chunk_bits))
        else:
            w.write(chunk_bits + 1, chunk)
            return


def _etc1s_layout(ep_cb: bytes, sel_cb: bytes, tables: bytes, n_slices: int):
    """File offsets of the ETC1S sections: codebooks, tables, slice
    descriptors, first payload."""
    ep_ofs = 77
    sel_ofs = ep_ofs + len(ep_cb)
    tab_ofs = sel_ofs + len(sel_cb)
    slice_desc_ofs = tab_ofs + len(tables)
    return ep_ofs, sel_ofs, tab_ofs, slice_desc_ofs, slice_desc_ofs + 23 * n_slices


def write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, hist_size, seed, is_video=False):
    """A one-slice .basis file that drives the ETC1S state machine; returns
    (file_bytes, expected_ep_idx, expected_sel_idx)."""
    rng = np.random.default_rng(seed)
    E, S, H = len(endpoints), len(selectors), hist_size

    ep_cb = encode_etc1s_endpoint_codebook(endpoints)
    sel_cb = encode_etc1s_selector_codebook(selectors)

    tw = BitWriterLsb()
    pred_enc = write_huffman_table(tw, equal_length_sizes(257))
    delta_enc = write_huffman_table(tw, equal_length_sizes(E))
    sel_enc = write_huffman_table(tw, equal_length_sizes(S + H + 1))
    rle_enc = write_huffman_table(tw, equal_length_sizes(64))
    tw.write(13, H)
    tables = tw.getvalue()

    w = BitWriterLsb()
    enc = Etc1sSliceFuzzEncoder(E, S, H, rng, is_video)
    ep_idx, sel_idx = enc.encode_slice(w, pred_enc, delta_enc, sel_enc, rle_enc, nbx, nby)
    payload = w.getvalue()

    ep_ofs, sel_ofs, tab_ofs, slice_desc_ofs, payload_ofs = _etc1s_layout(ep_cb, sel_cb, tables, 1)
    desc = _pack_slice_desc(0, 0, 0, nbx * 4, nby * 4, nbx, nby, payload_ofs, len(payload), crc16(payload))
    body = ep_cb + sel_cb + tables + desc + payload
    header = _pack_header(
        data_size=len(body),
        data_crc16=crc16(body),
        total_slices=1,
        total_images=1,
        tex_format=0,
        flags=1,
        tex_type=3 if is_video else 0,
        total_endpoints=E,
        endpoint_ofs=ep_ofs,
        endpoint_size=len(ep_cb),
        total_selectors=S,
        selector_ofs=sel_ofs,
        selector_size=len(sel_cb),
        tables_ofs=tab_ofs,
        tables_size=len(tables),
        slice_desc_ofs=slice_desc_ofs,
    )
    return header + body, ep_idx, sel_idx


def _pack_fields(values: np.ndarray, widths: np.ndarray) -> bytes:
    """The bytes a BitWriterLsb holds after write(widths[k], values[k]) for
    k = 0, 1, ...: each field at the bit position after the ones before it,
    LSB first.  A field is at most 57 bits wide."""
    total = int(widths.sum())
    if total == 0:
        return b""
    pos = np.cumsum(widths, dtype=np.int64) - widths
    shifted = values.astype(np.uint64) << (pos & 7).astype(np.uint64)
    byte = pos >> 3
    nbytes = (total + 7) // 8
    out = np.zeros(nbytes + 8, np.float64)
    # the fields occupy disjoint bits, so summing each output byte's shares
    # equals OR-ing them, and every sum (at most 255) is exact in float64
    for k in range(8):
        part = (shifted >> np.uint64(8 * k)) & np.uint64(0xFF)
        if not part.any():
            break
        out += np.bincount(byte + k, weights=part.astype(np.float64), minlength=nbytes + 8)
    return out[:nbytes].astype(np.uint8).tobytes()


def _etc1s_slice_payload(ep_idx, sel_idx, nbx, nby, E, pred_code, delta_codes, sel_codes) -> bytes:
    """One slice of write_etc1s_basis: in raster order, the 1-bit pred-3
    symbol at the top-left block of each 2x2 group, then each block's
    endpoint delta (from the previous block; 0 before the first) and its
    selector index, every code of fixed width."""
    ep = np.asarray(ep_idx).reshape(-1).astype(np.int64)
    sel = np.asarray(sel_idx).reshape(-1).astype(np.int64)
    delta = np.diff(ep, prepend=0) % E
    (pc, pw), (dc, dw), (sc, sw) = pred_code, delta_codes, sel_codes
    by, bx = np.divmod(np.arange(nbx * nby), nbx)
    group = ((bx % 2 == 0) & (by % 2 == 0)).astype(np.uint64)
    pred_w = group * np.uint64(pw)
    values = (group * np.uint64(pc)) | (dc[delta] << pred_w) | (sc[sel] << (pred_w + dw[delta]))
    return _pack_fields(values, (pred_w + dw[delta] + sw[sel]).astype(np.int64))


def write_etc1s_basis(
    endpoints: np.ndarray,
    selectors: np.ndarray,
    slices,
    has_alpha: bool = False,
) -> bytes:
    """A complete ETC1S .basis file.

    endpoints: uint8 [E,4]; selectors: uint8 [S,4];
    slices: list of {ep_idx: [n], sel_idx: [n], nbx, nby, orig_width,
    orig_height, (optional) alpha: bool}.
    """
    E, S = len(endpoints), len(selectors)

    ep_cb = encode_etc1s_endpoint_codebook(endpoints)
    sel_cb = encode_etc1s_selector_codebook(selectors)

    # models shared by all slices
    tw = BitWriterLsb()
    pred_sizes = [0] * 256
    pred_sizes[255] = 1
    pred_enc = write_huffman_table(tw, pred_sizes)
    delta_enc = write_huffman_table(tw, equal_length_sizes(E))
    sel_enc = write_huffman_table(tw, equal_length_sizes(S))
    write_huffman_table(tw, [1])  # history RLE model (unused, must parse)
    tw.write(13, 0)  # selector history buffer size = 0
    tables = tw.getvalue()

    pred_code = pred_enc.codes[255]  # pred 3 for the whole 2x2 group
    delta_codes, sel_codes = delta_enc.code_table(), sel_enc.code_table()
    payloads = [
        _etc1s_slice_payload(s["ep_idx"], s["sel_idx"], s["nbx"], s["nby"], E, pred_code, delta_codes, sel_codes)
        for s in slices
    ]

    ep_ofs, sel_ofs, tab_ofs, slice_desc_ofs, payload_ofs = _etc1s_layout(ep_cb, sel_cb, tables, len(slices))
    descs = []
    ofs = payload_ofs
    for i, (s, data) in enumerate(zip(slices, payloads)):
        flags = 1 if s.get("alpha") else 0
        descs.append(
            _pack_slice_desc(
                i // (2 if has_alpha else 1), 0, flags,
                s["orig_width"], s["orig_height"], s["nbx"], s["nby"],
                ofs, len(data), crc16(data),
            )
        )
        ofs += len(data)

    body = ep_cb + sel_cb + tables + b"".join(descs) + b"".join(payloads)
    header = _pack_header(
        data_size=len(body),
        data_crc16=crc16(body),
        total_slices=len(slices),
        total_images=len(slices) // (2 if has_alpha else 1),
        tex_format=0,  # ETC1S
        flags=(4 if has_alpha else 0) | 1,
        tex_type=0,
        total_endpoints=E,
        endpoint_ofs=ep_ofs,
        endpoint_size=len(ep_cb),
        total_selectors=S,
        selector_ofs=sel_ofs,
        selector_size=len(sel_cb),
        tables_ofs=tab_ofs,
        tables_size=len(tables),
        slice_desc_ofs=slice_desc_ofs,
    )
    return header + body
