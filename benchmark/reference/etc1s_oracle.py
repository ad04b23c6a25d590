"""The benchmark's ETC1S reference: a frozen copy of the repository's
sequential ETC1S oracle, an independent transcription of the reference
decoder (basisu_rs).  The benchmark decodes with it the codebooks and
Huffman tables of a file; `etc1s.py` beside it decodes the slices'
fixed-width index streams vectorised and checks them against this
module's sequential state machine in the benchmark's tests.

Transcribed line-by-line from:
  - src/bitreader.rs            (_OBitReader)
  - src/basis_lz/huffman.rs     (_OHuffTable, read table)
  - src/basis_lz/mod.rs:461-583 (codebooks)
  - src/basis_lz/mod.rs:188-458 (block state machine)
  - src/basis_lz/mod.rs:97-186  (RGBA / ETC1 back-ends)
  - src/target_formats/etc.rs:343-468 (ETC helpers)
  - src/basis.rs:8-90,262-298   (file walk)

It imports nothing of either package of the repository: its value is its
independence.
"""

from __future__ import annotations

import struct

# -- bitreader.rs ------------------------------------------------------------


class _OBitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0

    def peek(self, count: int) -> int:
        assert count <= 32
        byte = self.bit_pos // 8
        bit = self.bit_pos % 8
        result = (self.data[byte] if byte < len(self.data) else 0) >> bit
        read = 8 - bit
        byte += 1
        while read < count:
            result |= (self.data[byte] if byte < len(self.data) else 0) << read
            read += 8
            byte += 1
        return result & ((1 << count) - 1)

    def remove(self, count: int) -> None:
        self.bit_pos += count

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.remove(count)
        return v

    def read_bool(self) -> bool:
        return self.read(1) == 1


# -- basis_lz/huffman.rs -----------------------------------------------------

_MAX_CODE_SIZE = 16
_MAX_SYMS_LOG2 = 14


class OracleError(Exception):
    pass


def _reverse_bits_u32(v: int) -> int:
    out = 0
    for i in range(32):
        out = (out << 1) | ((v >> i) & 1)
    return out


class _OHuffTable:
    def __init__(self, lookup, max_code_size):
        self.lookup = lookup  # list of (symbol, code_size)
        self.max_code_size = max_code_size

    @classmethod
    def from_sizes(cls, code_sizes) -> "_OHuffTable":
        syms_using = [0] * (_MAX_CODE_SIZE + 1)
        max_code_size = 0
        for count in code_sizes:
            syms_using[count] += 1
            max_code_size = max(max_code_size, count)

        total = 0
        next_code = [0] * (_MAX_CODE_SIZE + 1)
        syms_using[0] = 0
        for bits in range(1, _MAX_CODE_SIZE + 1):
            total = (total + syms_using[bits - 1]) << 1
            next_code[bits] = total

        lookup = [(0, 0)] * (1 << max_code_size)
        for symbol, code_size in enumerate(code_sizes):
            if code_size != 0:
                size = code_size
                code = (_reverse_bits_u32(next_code[size]) >> (32 - size)) & 0xFFFF
                variant_count = 1 << (max_code_size - size)
                for fill in range(variant_count):
                    lookup[((fill << size) & 0xFFFF) | code] = (symbol, code_size)
                next_code[size] += 1

        if any(c > 0x10000 for c in next_code):
            raise OracleError("Code lengths are invalid, codes don't fit into 16 bits")
        return cls(lookup, max_code_size)

    def decode_symbol(self, reader: _OBitReader) -> int:
        bits = reader.peek(self.max_code_size)
        symbol, code_size = self.lookup[bits]
        if code_size > 0:
            reader.remove(code_size)
            return symbol
        raise OracleError(f"No matching code found in the decoding table, bits: {bits:016b}")


_CODELENGTH_INDICES = [17, 18, 19, 20, 0, 8, 7, 9, 6, 0xA, 5, 0xB, 4, 0xC, 3, 0xD, 2, 0xE, 1, 0xF, 0x10]


def _oracle_read_huffman_table(reader: _OBitReader) -> _OHuffTable:
    total_used_syms = reader.read(_MAX_SYMS_LOG2)

    num_codelength_codes = reader.read(5)
    codelength_code_sizes = [0] * 21
    for i in range(num_codelength_codes):
        codelength_code_sizes[_CODELENGTH_INDICES[i]] = reader.read(3)
    codelength_table = _OHuffTable.from_sizes(codelength_code_sizes)

    symbol_code_sizes: list[int] = []
    while len(symbol_code_sizes) < total_used_syms:
        s = codelength_table.decode_symbol(reader)
        if s <= 16:
            symbol_code_sizes.append(s)
        elif s == 17:  # small zero run 3-10
            symbol_code_sizes.extend([0] * (3 + reader.read(3)))
        elif s == 18:  # big zero run 11-138
            symbol_code_sizes.extend([0] * (11 + reader.read(7)))
        elif s in (19, 20):  # small/big repeat
            if not symbol_code_sizes:
                raise OracleError("Encountered repeat code as the first code")
            prev = symbol_code_sizes[-1]
            if prev == 0:
                raise OracleError("Repeat code, but the previous symbol's code length was 0")
            count = (3 + reader.read(2)) if s == 19 else (7 + reader.read(7))
            symbol_code_sizes.extend([prev] * count)
        else:
            raise OracleError("unreachable")
    return _OHuffTable.from_sizes(symbol_code_sizes)


# -- basis_lz/mod.rs codebooks ------------------------------------------------


def oracle_decode_endpoints(num_endpoints: int, data: bytes):
    """-> list of (color5 [r,g,b], inten5) tuples (mod.rs:461-516)."""
    reader = _OBitReader(data)
    model0 = _oracle_read_huffman_table(reader)
    model1 = _oracle_read_huffman_table(reader)
    model2 = _oracle_read_huffman_table(reader)
    inten_model = _oracle_read_huffman_table(reader)
    grayscale = reader.read_bool()

    prev_color5 = [16, 16, 16]
    prev_inten = 0
    endpoints = []
    for _ in range(num_endpoints):
        inten_delta = inten_model.decode_symbol(reader)
        inten5 = (inten_delta + prev_inten) & 7
        prev_inten = inten5

        color5 = [0, 0, 0]
        channel_count = 1 if grayscale else 3
        for c in range(channel_count):
            p = prev_color5[c]
            if 0 <= p <= 9:
                delta = model0.decode_symbol(reader)
            elif 10 <= p <= 21:
                delta = model1.decode_symbol(reader)
            elif 22 <= p <= 31:
                delta = model2.decode_symbol(reader)
            else:
                raise OracleError("unreachable")
            v = (p + delta) & 31
            color5[c] = v
            prev_color5[c] = v
        if grayscale:
            color5[1] = color5[0]
            color5[2] = color5[0]
        endpoints.append((color5, inten5))
    return endpoints


_SELECTOR_ID_TO_ETC1 = [0b11, 0b10, 0b00, 0b01]


class _OSelector:
    """Dual-representation selector (etc.rs:343-394)."""

    def __init__(self):
        self.rows = [0, 0, 0, 0]  # 2-bit selectors packed per row
        self.etc1_bytes = [0, 0, 0, 0]

    def get(self, x, y):
        return (self.rows[y] >> (2 * x)) & 3

    def set(self, x, y, val):
        shift = 2 * x
        self.rows[y] = (self.rows[y] & ~(3 << shift)) | (val << shift)
        mod_id = _SELECTOR_ID_TO_ETC1[val]
        pixel_id = x * 4 + y
        ms_byte_id = 1 - pixel_id // 8
        ls_byte_id = ms_byte_id + 2
        bit_id = pixel_id % 8
        self.etc1_bytes[ls_byte_id] = (self.etc1_bytes[ls_byte_id] & ~(1 << bit_id)) | (
            (mod_id % 2) << bit_id
        )
        self.etc1_bytes[ms_byte_id] = (self.etc1_bytes[ms_byte_id] & ~(1 << bit_id)) | (
            (mod_id // 2) << bit_id
        )


def oracle_decode_selectors(num_selectors: int, data: bytes):
    """-> list of _OSelector (mod.rs:524-583)."""
    reader = _OBitReader(data)
    is_global = reader.read_bool()
    hybrid = reader.read_bool()
    raw = reader.read_bool()
    if is_global:
        raise OracleError("Global selector codebooks are not supported")
    if hybrid:
        raise OracleError("Hybrid selector codebooks are not supported")

    selectors = [_OSelector() for _ in range(num_selectors)]
    if not raw:
        delta_model = _oracle_read_huffman_table(reader)
        prev_bytes = [0, 0, 0, 0]
        for i, selector in enumerate(selectors):
            for y in range(4):
                if i == 0:
                    cur_byte = reader.read(8)
                else:
                    cur_byte = delta_model.decode_symbol(reader) ^ prev_bytes[y]
                prev_bytes[y] = cur_byte
                for x in range(4):
                    selector.set(x, y, (cur_byte >> (x * 2)) & 3)
    else:
        for selector in selectors:
            for y in range(4):
                cur_byte = reader.read(8)
                for x in range(4):
                    selector.set(x, y, (cur_byte >> (x * 2)) & 3)
    return selectors


# -- basis_lz/mod.rs block state machine --------------------------------------


def _decode_vlc(reader: _OBitReader, chunk_bits: int) -> int:
    chunk_size = 1 << chunk_bits
    chunk_mask = chunk_size - 1
    v = 0
    ofs = 0
    while True:
        s = reader.read(chunk_bits + 1)
        v |= (s & chunk_mask) << ofs
        ofs += chunk_bits
        if (s & chunk_size) == 0:
            return v
        if ofs >= 32:
            raise OracleError("vlc overflow")


class _OApproxMoveToFront:
    def __init__(self, n):
        self.values = [0] * n
        self.rover = n // 2

    def add(self, new_value):
        self.values[self.rover] = new_value
        self.rover += 1
        if self.rover == len(self.values):
            self.rover = len(self.values) // 2

    def use_index(self, index):
        if index > 0:
            x = self.values[index // 2]
            self.values[index // 2] = self.values[index]
            self.values[index] = x


class OracleEtc1sDecoder:
    """Transcription of basis_lz::Decoder (mod.rs:50-458)."""

    def __init__(self, endpoint_count, selector_count, endpoints_data, selector_data,
                 tables_data, is_video=False):
        self.endpoints = oracle_decode_endpoints(endpoint_count, endpoints_data)
        self.selectors = oracle_decode_selectors(selector_count, selector_data)
        reader = _OBitReader(tables_data)
        self.endpoint_pred_model = _oracle_read_huffman_table(reader)
        self.delta_endpoint_model = _oracle_read_huffman_table(reader)
        self.selector_model = _oracle_read_huffman_table(reader)
        self.selector_history_buf_rle_model = _oracle_read_huffman_table(reader)
        self.selector_history_buffer_size = reader.read(13)
        self.is_video = is_video

    def decode_blocks(self, num_blocks_x: int, num_blocks_y: int, block_data: bytes):
        """-> list of (endpoint_index, selector_index) in raster order."""
        ENDPOINT_PRED_REPEAT_LAST_SYMBOL = 4 * 4 * 4 * 4
        CR_ENDPOINT_PRED_INDEX = 2

        reader = _OBitReader(block_data)
        num_endpoints = len(self.endpoints)
        num_selectors = len(self.selectors)

        block_endpoint_preds = [
            [[0, 0] for _ in range(num_blocks_x)],  # [endpoint_index, pred_bits]
            [[0, 0] for _ in range(num_blocks_x)],
        ]

        selector_history_buf_rle_symbol_index = self.selector_history_buffer_size + num_selectors
        cur_selector_rle_count = 0
        cur_pred_bits = 0
        prev_endpoint_pred_sym = 0
        endpoint_pred_repeat_count = 0
        prev_endpoint_index = 0

        prev_frame_indices = [[0, 0] for _ in range(num_blocks_x * num_blocks_y)]
        selector_history_buf = _OApproxMoveToFront(self.selector_history_buffer_size)

        out = []
        for block_y in range(num_blocks_y):
            cur_arr = block_y & 1
            for block_x in range(num_blocks_x):
                if block_x & 1 == 0:
                    if block_y & 1 == 0:
                        if endpoint_pred_repeat_count != 0:
                            endpoint_pred_repeat_count -= 1
                            cur_pred_bits = prev_endpoint_pred_sym
                        else:
                            pred_bits_sym = self.endpoint_pred_model.decode_symbol(reader)
                            if pred_bits_sym == ENDPOINT_PRED_REPEAT_LAST_SYMBOL:
                                endpoint_pred_repeat_count = _decode_vlc(reader, 4) + 3 - 1
                                cur_pred_bits = prev_endpoint_pred_sym
                            else:
                                cur_pred_bits = pred_bits_sym
                                prev_endpoint_pred_sym = cur_pred_bits
                        block_endpoint_preds[cur_arr ^ 1][block_x][1] = cur_pred_bits >> 4
                    else:
                        cur_pred_bits = block_endpoint_preds[cur_arr][block_x][1]

                pred = cur_pred_bits & 3
                cur_pred_bits >>= 2

                if pred == 0:
                    assert block_x > 0
                    endpoint_index = prev_endpoint_index
                elif pred == 1:
                    assert block_y > 0
                    endpoint_index = block_endpoint_preds[cur_arr ^ 1][block_x][0]
                elif pred == 2:
                    if self.is_video:
                        endpoint_index = prev_frame_indices[block_x + block_y * num_blocks_x][0]
                    else:
                        assert block_x > 0 and block_y > 0
                        endpoint_index = block_endpoint_preds[cur_arr ^ 1][block_x - 1][0]
                else:
                    delta_sym = self.delta_endpoint_model.decode_symbol(reader)
                    endpoint_index = delta_sym + prev_endpoint_index
                    if endpoint_index >= num_endpoints:
                        endpoint_index -= num_endpoints

                block_endpoint_preds[cur_arr][block_x][0] = endpoint_index
                prev_endpoint_index = endpoint_index

                if not self.is_video or pred != CR_ENDPOINT_PRED_INDEX:
                    if cur_selector_rle_count > 0:
                        cur_selector_rle_count -= 1
                        selector_sym = num_selectors
                    else:
                        sym = self.selector_model.decode_symbol(reader)
                        if sym == selector_history_buf_rle_symbol_index:
                            run_sym = self.selector_history_buf_rle_model.decode_symbol(reader)
                            if run_sym == 63:  # SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1
                                cur_selector_rle_count = 3 + _decode_vlc(reader, 7)
                            else:
                                cur_selector_rle_count = 3 + run_sym
                            cur_selector_rle_count -= 1
                            selector_sym = num_selectors
                        else:
                            selector_sym = sym

                    if selector_sym >= num_selectors:
                        assert self.selector_history_buffer_size > 0
                        history_buf_index = selector_sym - num_selectors
                        selector_index = selector_history_buf.values[history_buf_index]
                        if history_buf_index != 0:
                            selector_history_buf.use_index(history_buf_index)
                    else:
                        if self.selector_history_buffer_size > 0:
                            selector_history_buf.add(selector_sym)
                        selector_index = selector_sym
                else:
                    selector_index = prev_frame_indices[block_x + block_y * num_blocks_x][1]

                if self.is_video:
                    prev_frame_indices[block_x + num_blocks_x * block_y] = [
                        endpoint_index,
                        selector_index,
                    ]

                assert endpoint_index < num_endpoints
                assert selector_index < num_selectors
                out.append((endpoint_index, selector_index))
        return out

    # -- back-ends (mod.rs:97-186) --------------------------------------------

    def decode_to_rgba(self, num_blocks_x, num_blocks_y, rgb_data, alpha_data=None):
        """-> list of [r,g,b,a] pixels, raster order, width = 4*num_blocks_x."""
        pixels = [[0, 0, 0, 0] for _ in range(num_blocks_x * num_blocks_y * 16)]
        self._decode_to_rgba_internal(num_blocks_x, num_blocks_y, rgb_data, pixels, False)
        if alpha_data is not None:
            self._decode_to_rgba_internal(num_blocks_x, num_blocks_y, alpha_data, pixels, True)
        return pixels

    def _decode_to_rgba_internal(self, num_blocks_x, num_blocks_y, block_data, pixels, alpha):
        blocks = self.decode_blocks(num_blocks_x, num_blocks_y, block_data)
        stride = num_blocks_x * 4
        for i, (ep_idx, sel_idx) in enumerate(blocks):
            block_x, block_y = i % num_blocks_x, i // num_blocks_x
            color5, inten5 = self.endpoints[ep_idx]
            selector = self.selectors[sel_idx]
            base = [(c << 3) | (c >> 2) for c in color5]
            colors = [
                [max(0, min(255, b + m)) for b in base] + [255]
                for m in _ETC1_MODIFIERS[inten5]
            ]
            for y in range(4):
                for x in range(4):
                    sel = selector.get(x, y)
                    gid = (block_x * 4 + x) + (block_y * 4 + y) * stride
                    if not alpha:
                        pixels[gid] = list(colors[sel])
                    else:
                        pixels[gid][3] = colors[sel][1]

    def transcode_to_etc1(self, num_blocks_x, num_blocks_y, block_data):
        """-> bytes, 8 per block (mod.rs:153-186)."""
        blocks = self.decode_blocks(num_blocks_x, num_blocks_y, block_data)
        out = bytearray(8 * len(blocks))
        for i, (ep_idx, sel_idx) in enumerate(blocks):
            color5, inten5 = self.endpoints[ep_idx]
            selector = self.selectors[sel_idx]
            s = i * 8
            out[s + 0] = color5[0] << 3
            out[s + 1] = color5[1] << 3
            out[s + 2] = color5[2] << 3
            out[s + 3] = (inten5 << 5) | (inten5 << 2) | 0b11
            out[s + 4 : s + 8] = bytes(selector.etc1_bytes)
        return bytes(out)


_ETC1_MODIFIERS = [
    [-8, -2, 2, 8],
    [-17, -5, 5, 17],
    [-29, -9, 9, 29],
    [-42, -13, 13, 42],
    [-60, -18, 18, 60],
    [-80, -24, 24, 80],
    [-106, -33, 33, 106],
    [-183, -47, 47, 183],
]


# -- basis.rs file walk --------------------------------------------------------


def _oracle_header(buf: bytes) -> dict:
    """Independent header field extraction (basis.rs:417-517 layout)."""
    assert struct.unpack_from("<H", buf, 0)[0] == 0x4273
    h = {}
    h["total_slices"] = buf[14] | (buf[15] << 8) | (buf[16] << 16)
    h["tex_format"] = buf[20]
    (h["flags"],) = struct.unpack_from("<H", buf, 21)
    h["tex_type"] = buf[23]
    (h["total_endpoints"], h["endpoint_ofs"]) = struct.unpack_from("<HI", buf, 39)
    h["endpoint_size"] = buf[45] | (buf[46] << 8) | (buf[47] << 16)
    (h["total_selectors"], h["selector_ofs"]) = struct.unpack_from("<HI", buf, 48)
    h["selector_size"] = buf[54] | (buf[55] << 8) | (buf[56] << 16)
    (h["tables_ofs"], h["tables_size"], h["slice_ofs"]) = struct.unpack_from("<3I", buf, 57)
    return h


def _oracle_slice_descs(buf: bytes, h: dict) -> list:
    descs = []
    for i in range(h["total_slices"]):
        o = h["slice_ofs"] + i * 23
        d = {}
        d["flags"] = buf[o + 4]
        (d["orig_width"], d["orig_height"], d["nbx"], d["nby"]) = struct.unpack_from(
            "<4H", buf, o + 5
        )
        (d["file_ofs"], d["file_size"]) = struct.unpack_from("<2I", buf, o + 13)
        descs.append(d)
    return descs


def oracle_make_decoder(buf: bytes, quirk_endpoint_count: bool = False) -> OracleEtc1sDecoder:
    """Build the decoder from header byte ranges (basis.rs:262-298).

    quirk_endpoint_count=True replicates the reference verbatim, which passes
    `total_selectors` as the endpoint count (basis.rs:290-291).  The default
    (False) uses `total_endpoints`, which is what files from the official
    encoder require and what the program implements."""
    h = _oracle_header(buf)
    ep_count = h["total_selectors"] if quirk_endpoint_count else h["total_endpoints"]
    return OracleEtc1sDecoder(
        ep_count,
        h["total_selectors"],
        buf[h["endpoint_ofs"] : h["endpoint_ofs"] + h["endpoint_size"]],
        buf[h["selector_ofs"] : h["selector_ofs"] + h["selector_size"]],
        buf[h["tables_ofs"] : h["tables_ofs"] + h["tables_size"]],
        is_video=h["tex_type"] == 3,
    )


def oracle_read_to_rgba(buf: bytes) -> list:
    """-> list of (w, h, pixel-list) per image, mirroring basis.rs:8-90
    (ETC1S path only; RGB+alpha slice pairing as in basis.rs:26-53)."""
    h = _oracle_header(buf)
    assert h["tex_format"] == 0, "oracle handles ETC1S files only"
    descs = _oracle_slice_descs(buf, h)
    dec = oracle_make_decoder(buf)
    has_alpha = bool(h["flags"] & 4)
    images = []
    step = 2 if has_alpha else 1
    for i in range(0, len(descs), step):
        d = descs[i]
        rgb = buf[d["file_ofs"] : d["file_ofs"] + d["file_size"]]
        alpha = None
        if has_alpha:
            da = descs[i + 1]
            alpha = buf[da["file_ofs"] : da["file_ofs"] + da["file_size"]]
        pixels = dec.decode_to_rgba(d["nbx"], d["nby"], rgb, alpha)
        images.append((d["orig_width"], d["orig_height"], pixels))
    return images


def oracle_read_to_etc1(buf: bytes) -> list:
    """-> list of (w, h, block-bytes) per slice (basis.rs:92-130 analog)."""
    h = _oracle_header(buf)
    assert h["tex_format"] == 0
    descs = _oracle_slice_descs(buf, h)
    dec = oracle_make_decoder(buf)
    images = []
    for d in descs:
        data = buf[d["file_ofs"] : d["file_ofs"] + d["file_size"]]
        images.append((d["orig_width"], d["orig_height"], dec.transcode_to_etc1(d["nbx"], d["nby"], data)))
    return images
