"""The benchmark's UASTC reference: the BC7 half of a frozen copy of the
repository's sequential UASTC oracle, an independent transcription of the
reference transcoder (basisu_rs).  It lives here so that a later change to
the program or to its tests cannot move the yardstick.  The one addition
is the `rnd` hook of the BC7 p-bit search (`_determine_pbits`), which the
benchmark's control uses to run that float32 search in bfloat16.  The
oracle's other targets (RGBA, ASTC, ETC1/ETC2) are left out until a cell
transcodes to them.

Transcribed line-by-line from:
  - src/bitreader.rs                 (_OBitReader)
  - src/uastc.rs:237-341             (decode_mode, decode_compsel,
    decode_pattern_index, get_pattern)
  - src/uastc.rs:378-394             (anchors, mode 8)
  - src/uastc.rs:585-740             (BISE endpoint decode /
    unquant, weight decode)
  - src/uastc.rs:176-235             (endpoint pair assembly)
  - src/uastc.rs:527-577,742-811     (MODES, MODE_LUT,
    patterns, anchors)
  - src/target_formats/astc.rs:300-331 (BISE_RANGES)
  - src/target_formats/bc7.rs        (convert_block_to_bc7)

It imports nothing of either package of the repository: its value is its
independence.
"""

from __future__ import annotations


class OracleUastcError(Exception):
    """Mirrors the reference's Err(String) sites in the RGBA decode path."""


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


# -- uastc.rs:527-557 MODES --------------------------------------------------
# (id, code_size, endpoint_range_index, format, weight_bits, plane_count,
#  subset_count, trans_flags_bits); format: 0=RGB, 1=RGBA, 2=LA

_RGB, _RGBA, _LA = 0, 1, 2

_MODES = [
    (0, 4, 19, _RGB, 4, 1, 1, 15),
    (1, 6, 20, _RGB, 2, 1, 1, 15),
    (2, 5, 8, _RGB, 3, 1, 2, 15),
    (3, 5, 7, _RGB, 2, 1, 3, 15),
    (4, 5, 12, _RGB, 2, 1, 2, 15),
    (5, 5, 20, _RGB, 3, 1, 1, 15),
    (6, 5, 18, _RGB, 2, 2, 1, 15),
    (7, 5, 12, _RGB, 2, 1, 2, 15),
    (8, 5, 0, _RGBA, 0, 1, 1, 0),
    (9, 5, 8, _RGBA, 2, 1, 2, 23),
    (10, 3, 13, _RGBA, 4, 1, 1, 17),
    (11, 2, 13, _RGBA, 2, 2, 1, 17),
    (12, 3, 19, _RGBA, 3, 1, 1, 17),
    (13, 5, 20, _RGBA, 1, 2, 1, 23),
    (14, 5, 20, _RGBA, 2, 1, 1, 23),
    (15, 7, 20, _LA, 4, 1, 1, 23),
    (16, 6, 20, _LA, 2, 1, 2, 23),
    (17, 6, 20, _LA, 2, 2, 1, 23),
    (18, 4, 11, _RGB, 5, 1, 1, 15),
]

# uastc.rs:559-577
_MODE_LUT = [
    11, 0, 10, 3, 11, 15, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 16, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 17, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 1, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 19, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 16, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 17, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 1, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
]

# astc.rs:309-331 BISE_RANGES: (bits, trits, quints, deq_b, deq_c)
_BISE_RANGES = [
    (1, 0, 0, "         ", 0),
    (0, 1, 0, "         ", 0),
    (2, 0, 0, "         ", 0),
    (0, 0, 1, "         ", 0),
    (1, 1, 0, "000000000", 204),
    (3, 0, 0, "         ", 0),
    (1, 0, 1, "000000000", 113),
    (2, 1, 0, "b000b0bb0", 93),
    (4, 0, 0, "         ", 0),
    (2, 0, 1, "b0000bb00", 54),
    (3, 1, 0, "cb000cbcb", 44),
    (5, 0, 0, "         ", 0),
    (3, 0, 1, "cb0000cbc", 26),
    (4, 1, 0, "dcb000dcb", 22),
    (6, 0, 0, "         ", 0),
    (4, 0, 1, "dcb0000dc", 13),
    (5, 1, 0, "edcb000ed", 11),
    (7, 0, 0, "         ", 0),
    (5, 0, 1, "edcb0000e", 6),
    (6, 1, 0, "fedcb000f", 5),
    (8, 0, 0, "         ", 0),
]


_PATTERNS_2_ANCHORS = [
    [0, 2], [0, 3], [1, 0], [0, 3], [7, 0], [0, 2], [3, 0],
    [7, 0], [0, 11], [2, 0], [0, 7], [11, 0], [3, 0], [8, 0],
    [0, 4], [12, 0], [1, 0], [8, 0], [0, 1], [0, 2], [0, 4],
    [8, 0], [1, 0], [0, 2], [4, 0], [0, 1], [4, 0], [1, 0],
    [4, 0], [1, 0],
]

_PATTERNS_3_ANCHORS = [
    [0, 8, 10], [8, 0, 12], [4, 0, 12], [8, 0, 4], [3, 0, 2],
    [0, 1, 3], [0, 2, 1], [1, 9, 0], [1, 2, 0], [4, 0, 8], [0, 6, 2],
]

_PATTERNS_2_3_ANCHORS = [
    [0, 4], [0, 2], [2, 0], [0, 7], [8, 0], [0, 1], [0, 3],
    [0, 1], [2, 0], [0, 1], [0, 8], [2, 0], [0, 1], [0, 7],
    [12, 0], [2, 0], [9, 0], [0, 2], [4, 0],
]


# -- uastc.rs:585-614 unquant_endpoint ---------------------------------------


def _unquant_endpoint(trit_quint: int, bits_val: int, range_index: int) -> int:
    bits, trits, quints, deq_b, deq_c = _BISE_RANGES[range_index]
    quant_bits = bits_val
    if trits == 0 and quints == 0 and bits > 0:
        bits_la = (quant_bits << (8 - bits)) & 0xFFFF
        val = 0
        while bits_la > 0:
            val |= bits_la
            bits_la >>= bits
        return val & 0xFF
    a = 511 if (quant_bits & 1) != 0 else 0
    b = 0
    for j in range(9):
        b = (b << 1) & 0xFFFF
        shift = ord(deq_b[j])
        if shift != ord("0"):
            b |= (quant_bits >> (shift - ord("a"))) & 0x1
    c = deq_c
    d = trit_quint
    val = (d * c + b) & 0xFFFF
    val ^= a
    return ((a & 0x80) | (val >> 2)) & 0xFF


# -- uastc.rs:616-695 decode_endpoints ---------------------------------------


def _decode_endpoints(r: _OBitReader, range_index: int, value_count: int):
    bits, trits, quints, _, _ = _BISE_RANGES[range_index]
    trit_quints = [0] * value_count
    bit_vals = [0] * value_count

    if quints > 0:
        out_pos = 0
        for _ in range(value_count // 3):
            q = r.read(7)
            for _ in range(3):
                trit_quints[out_pos] = q % 5
                q //= 5
                out_pos += 1
        remaining = value_count - out_pos
        if remaining > 0:
            bits_used = {1: 3, 2: 5}[remaining]
            q = r.read(bits_used)
            for _ in range(remaining):
                trit_quints[out_pos] = q % 5
                q //= 5
                out_pos += 1

    if trits > 0:
        out_pos = 0
        for _ in range(value_count // 5):
            t = r.read(8)
            for _ in range(5):
                trit_quints[out_pos] = t % 3
                t //= 3
                out_pos += 1
        remaining = value_count - out_pos
        if remaining > 0:
            bits_used = {1: 2, 2: 4, 3: 5, 4: 7}[remaining]
            t = r.read(bits_used)
            for _ in range(remaining):
                trit_quints[out_pos] = t % 3
                t //= 3
                out_pos += 1

    if bits > 0:
        for i in range(value_count):
            bit_vals[i] = r.read(bits)

    return trit_quints, bit_vals


# -- uastc.rs:721-740 decode_weights -----------------------------------------


def _anchor_indices(mode_id: int, subset_count: int, pat: int):
    if mode_id == 7:
        return _PATTERNS_2_3_ANCHORS[pat]
    if subset_count == 1:
        return [0]
    if subset_count == 2:
        return _PATTERNS_2_ANCHORS[pat]
    return _PATTERNS_3_ANCHORS[pat]


# -- uastc.rs:176-235 endpoint pair assembly ---------------------------------


def _assemble_endpoint_pairs(fmt: int, endpoint_bytes):
    # chunks_exact semantics: a trailing partial chunk is dropped, and (as in
    # the reference's [[Color32; 2]; 3] zip) at most 3 pairs are produced
    pairs = []
    step = {_RGB: 6, _RGBA: 8, _LA: 4}[fmt]
    for i in range(0, len(endpoint_bytes) - step + 1, step):
        if len(pairs) == 3:
            break
        b = endpoint_bytes[i : i + step]
        if fmt == _RGB:
            pairs.append(((b[0], b[2], b[4], 0xFF), (b[1], b[3], b[5], 0xFF)))
        elif fmt == _RGBA:
            pairs.append(((b[0], b[2], b[4], b[6]), (b[1], b[3], b[5], b[7])))
        else:  # LA
            pairs.append(((b[0], b[0], b[0], b[2]), (b[1], b[1], b[1], b[3])))
    return pairs


# -- bitwriter.rs ------------------------------------------------------------


class _OBitWriterLsb:
    def __init__(self, out: bytearray):
        self.out = out
        self.bit_pos = 0

    def write(self, count: int, v: int) -> None:
        assert count <= 32
        v &= (1 << count) - 1
        byte = self.bit_pos // 8
        bit = self.bit_pos % 8
        if byte < len(self.out):
            self.out[byte] |= (v << bit) & 0xFF
        written = 8 - bit
        byte += 1
        self.bit_pos += count
        while written < count:
            if byte < len(self.out):
                self.out[byte] |= (v >> written) & 0xFF
            written += 8
            byte += 1


# -- astc.rs:8-181 (the raw weight read BC7 reuses) ---------------------------


def _decode_weights_raw(r: _OBitReader, mode, pat: int):
    """decode_weights without unquantization: the consumer-order raw values."""
    mode_id, _, _, _, weight_bits, plane_count, subset_count, _ = mode
    bits = [weight_bits] * 16
    for anchor in _anchor_indices(mode_id, subset_count, pat):
        bits[anchor] = weight_bits - 1
    out = []
    for i in range(16):
        for _plane in range(plane_count):
            out.append(r.read(bits[i]))
    return out


# -- target_formats/bc7.rs ---------------------------------------------------

# (id, pat_bits, endpoint_count, color_bits, alpha_bits, weight_bits,
#  plane_count, subset_count, p_bits, sp_bits)  (bc7.rs:569-579)
_BC7_MODES = [
    (0, 4, 18, 4, 0, 3, 1, 3, 1, 0),
    (1, 6, 12, 6, 0, 3, 1, 2, 0, 1),
    (2, 6, 18, 5, 0, 2, 1, 3, 0, 0),
    (3, 6, 12, 7, 0, 2, 1, 2, 1, 0),
    (4, 0, 8, 5, 6, 2, 2, 1, 0, 0),
    (5, 0, 8, 7, 8, 2, 2, 1, 0, 0),
    (6, 0, 8, 7, 7, 4, 1, 1, 1, 0),
    (7, 6, 16, 5, 5, 2, 1, 2, 1, 0),
]

_UASTC_TO_BC7_MODES = [6, 3, 1, 2, 3, 6, 5, 2, 0, 7, 6, 5, 6, 5, 6, 6, 7, 5, 6, 0]

_PATTERNS_2_BC7_INDEX_INV = [
    (0, False), (1, False), (2, True), (3, False), (4, True), (5, False),
    (6, True), (7, True), (8, False), (9, True), (10, False), (11, True),
    (12, True), (13, True), (14, False), (15, True), (17, True), (18, True),
    (19, False), (20, False), (21, False), (22, True), (23, True),
    (24, False), (25, True), (26, False), (29, True), (32, True), (33, True),
    (52, True),
]

_PATTERNS_3_BC7_INDEX_PERM = [
    (4, 0), (8, 5), (9, 5), (10, 2), (11, 2), (12, 0), (13, 4), (20, 1),
    (35, 1), (36, 5), (57, 0),
]

_PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS = [
    [0, 1, 2], [2, 0, 1], [1, 2, 0], [2, 1, 0], [0, 2, 1], [1, 0, 2],
]

_PATTERNS_2_3_BC7_INDEX_PERM = [
    (10, 4), (11, 4), (0, 3), (2, 4), (8, 5), (13, 4), (1, 2), (33, 2),
    (40, 3), (20, 4), (21, 0), (58, 3), (3, 0), (32, 2), (59, 1), (34, 3),
    (20, 1), (14, 4), (31, 3),
]

_PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS = [
    [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 0], [0, 1, 0], [1, 0, 1],
]

_PATTERNS_2_BC7 = [
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1], [0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1], [0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1], [0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1], [0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0], [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],
    [0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0], [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0], [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1], [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0], [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],
    [0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0], [0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1],
    [0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1], [0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1],
]

_PATTERNS_3_BC7 = [
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2], [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2], [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2],
    [0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2], [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],
    [0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2], [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],
    [0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0], [0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0],
    [0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
]

_PATTERNS_2_3_BC7 = [
    [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2], [0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2],
    [0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2], [0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2], [0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2],
    [0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1], [0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1],
    [0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1], [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],
    [0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1], [0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2],
    [0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1], [0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2],
    [0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2], [0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2],
    [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2], [0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2],
    [0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1],
]

_PATTERNS_2_BC7_ANCHORS = [
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15],
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15],
    [0, 15], [0, 2], [0, 8], [0, 2], [0, 2], [0, 8], [0, 8], [0, 15],
    [0, 2], [0, 8], [0, 2], [0, 2], [0, 8], [0, 8], [0, 2], [0, 2],
    [0, 15], [0, 15], [0, 6], [0, 8], [0, 2], [0, 8], [0, 15], [0, 15],
    [0, 2], [0, 8], [0, 2], [0, 2], [0, 2], [0, 15], [0, 15], [0, 6],
    [0, 6], [0, 2], [0, 6], [0, 8], [0, 15], [0, 15], [0, 2], [0, 2],
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 2], [0, 2], [0, 15],
]

_PATTERNS_3_BC7_ANCHORS = [
    [0, 3, 15], [0, 3, 8], [0, 15, 8], [0, 15, 3], [0, 8, 15], [0, 3, 15],
    [0, 15, 3], [0, 15, 8], [0, 8, 15], [0, 8, 15], [0, 6, 15], [0, 6, 15],
    [0, 6, 15], [0, 5, 15], [0, 3, 15], [0, 3, 8], [0, 3, 15], [0, 3, 8],
    [0, 8, 15], [0, 15, 3], [0, 3, 15], [0, 3, 8], [0, 6, 15], [0, 10, 8],
    [0, 5, 3], [0, 8, 15], [0, 8, 6], [0, 6, 10], [0, 8, 15], [0, 5, 15],
    [0, 15, 10], [0, 15, 8], [0, 8, 15], [0, 15, 3], [0, 3, 15], [0, 5, 10],
    [0, 6, 10], [0, 10, 8], [0, 8, 9], [0, 15, 10], [0, 15, 6], [0, 3, 15],
    [0, 15, 8], [0, 5, 15], [0, 15, 3], [0, 15, 6], [0, 15, 6], [0, 15, 8],
    [0, 3, 15], [0, 15, 3], [0, 5, 15], [0, 5, 15], [0, 5, 15], [0, 8, 15],
    [0, 5, 15], [0, 10, 15], [0, 5, 15], [0, 10, 15], [0, 8, 15], [0, 13, 15],
    [0, 15, 3], [0, 12, 15], [0, 3, 15], [0, 3, 8],
]

_BC7ENC_MODE_5_OPTIMAL_INDEX = 1
_BC7ENC_MODE_6_OPTIMAL_INDEX = 5

_BC7_WEIGHTS2 = [0, 21, 43, 64]
_BC7_WEIGHTS4 = [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]


def _build_optimal_tables():
    """Brute-force builds of BC7_MODE_5_OPTIMAL_ENDPOINTS (bc7.rs:1214-1250)
    and BC7_MODE_6_OPTIMAL_ENDPOINTS (bc7.rs:1158-1212): the reference's own
    tests assert the committed tables equal these builds, so generating is
    equivalent to transcribing them (and far less error-prone)."""
    import numpy as _np

    l = _np.arange(128)[:, None]
    h = _np.arange(128)[None, :]
    invalid = (h < l) * (1 << 40)

    # mode 5: BC7 777, weight index 1 of WEIGHTS2
    w = _BC7_WEIGHTS2[_BC7ENC_MODE_5_OPTIMAL_INDEX]
    low = (l << 1) | (l >> 6)
    high = (h << 1) | (h >> 6)
    k5 = (low * (64 - w) + high * w + 32) >> 6

    # mode 6: BC7 777.1 with lp = 0, weight index 5 of WEIGHTS4
    w = _BC7_WEIGHTS4[_BC7ENC_MODE_6_OPTIMAL_INDEX]
    low = l << 1
    high = h << 1
    k6 = (low * (64 - w) + high * w + 32) >> 6

    def best(k, c):
        err = (k - c) ** 2 + invalid
        i = int(err.argmin())  # first minimal in (l-major, h-minor) order
        return (i // 128, i % 128)

    mode5 = [best(k5, c) for c in range(256)]
    mode6 = [(0, 0)] + [best(k6, c) for c in range(256)]
    return mode5, mode6


_OPTIMAL_TABLES = None


def _optimal_tables():
    global _OPTIMAL_TABLES
    if _OPTIMAL_TABLES is None:
        _OPTIMAL_TABLES = _build_optimal_tables()
    return _OPTIMAL_TABLES


def _convert_weights_to_bc7(weights, uastc_weight_bits, bc7_weight_bits):
    luts = {
        (1, 2): [0, 3],
        (2, 4): [0, 5, 10, 15],
        (3, 4): [0, 2, 4, 6, 9, 11, 13, 15],
        (5, 4): [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 8, 9, 9, 9,
                 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15],
    }
    if uastc_weight_bits == bc7_weight_bits:
        return list(weights)
    lut = luts[(uastc_weight_bits, bc7_weight_bits)]
    return [lut[w] for w in weights]


def _exact(x):
    return x


def _determine_pbits(total_comps, comp_bits, endpoint_pair, shared: bool, rnd=_exact):
    """bc7.rs:408-553: f32 p-bit search; mutates endpoint_pair in place.
    rnd rounds every float32 result (the control passes a bfloat16
    rounding; the reference leaves each result exact)."""
    import numpy as _np

    def f32(v):
        return rnd(_np.float32(v))

    total_bits = comp_bits + 1
    iscalep = (1 << total_bits) - 1
    scalep = f32(iscalep)

    xl = [f32(f32(endpoint_pair[0][c]) / f32(255.0)) for c in range(4)]
    xh = [f32(f32(endpoint_pair[1][c]) / f32(255.0)) for c in range(4)]

    best_err = f32(1e9)
    best_err0 = f32(1e9)
    best_err1 = f32(1e9)
    s_bit = 0
    p_bits = [0, 0]
    out_lo = [0, 0, 0, 0]
    out_hi = [0, 0, 0, 0]

    def unit(x, p):
        return int(f32(f32(f32(f32(x * scalep) - f32(p)) / f32(2.0)) + f32(0.5)))  # trunc

    for p in range(2):
        x_min = []
        x_max = []
        for c in range(4):
            t = unit(xl[c], p)
            x_min.append(max(p, min(iscalep - 1 + p, t * 2 + p)))
            t = unit(xh[c], p)
            x_max.append(max(p, min(iscalep - 1 + p, t * 2 + p)))

        scaled_low = []
        scaled_high = []
        for c in range(4):
            s = (x_min[c] << (8 - total_bits)) & 0xFF
            scaled_low.append(s | (s >> total_bits))
            s = (x_max[c] << (8 - total_bits)) & 0xFF
            scaled_high.append(s | (s >> total_bits))

        if shared:
            err = f32(0.0)
            for i in range(total_comps):
                dl = f32(f32(f32(scaled_low[i]) / f32(255.0)) - xl[i])
                dh = f32(f32(f32(scaled_high[i]) / f32(255.0)) - xh[i])
                err = f32(err + f32(f32(dl * dl) + f32(dh * dh)))
            if err < best_err:
                best_err = err
                s_bit = p
                out_lo = [x >> 1 for x in x_min]
                out_hi = [x >> 1 for x in x_max]
        else:
            err0 = f32(0.0)
            err1 = f32(0.0)
            for i in range(total_comps):
                d0 = f32(f32(scaled_low[i]) - f32(xl[i] * f32(255.0)))
                d1 = f32(f32(scaled_high[i]) - f32(xh[i] * f32(255.0)))
                err0 = f32(err0 + f32(d0 * d0))
                err1 = f32(err1 + f32(d1 * d1))
            if err0 < best_err0:
                best_err0 = err0
                p_bits[0] = p
                out_lo = [x >> 1 for x in x_min]
            if err1 < best_err1:
                best_err1 = err1
                p_bits[1] = p
                out_hi = [x >> 1 for x in x_max]

    endpoint_pair[0] = out_lo
    endpoint_pair[1] = out_hi
    return [s_bit, s_bit] if shared else p_bits


def convert_block_to_bc7(block: bytes, rnd=_exact) -> bytes:
    """16 UASTC block bytes -> 16 BC7 block bytes (bc7.rs:9-310); rnd as in
    _determine_pbits."""
    assert len(block) == 16
    r = _OBitReader(block)

    mode_code = r.peek(7)
    mode_index = _MODE_LUT[mode_code]
    if mode_index >= len(_MODES):
        raise OracleUastcError("invalid mode index")
    mode = _MODES[mode_index]
    (mode_id, code_size, range_index, fmt, uastc_weight_bits, plane_count,
     subset_count, trans_flags_bits) = mode
    r.remove(code_size)

    output = bytearray(16)
    w = _OBitWriterLsb(output)

    if mode_id == 8:
        rgba8 = [r.read(8) for _ in range(4)]
        mode5_tab, mode6_tab = _optimal_tables()
        # mode_6_optimal_endpoint_err: only c==0 (p=1) / c==255 (p=0) err 1
        best_err0 = sum(1 for c in rgba8 if c == 255)
        best_err1 = sum(1 for c in rgba8 if c == 0)
        if best_err0 > 0 and best_err1 > 0:
            bmode = 5
            endpoint = [[0] * 4, [0] * 4]
            for c in range(3):
                endpoint[0][c] = mode5_tab[rgba8[c]][0]
                endpoint[1][c] = mode5_tab[rgba8[c]][1]
            endpoint[0][3] = rgba8[3]
            endpoint[1][3] = rgba8[3]
            p01 = [0, 0]
            wts = [_BC7ENC_MODE_5_OPTIMAL_INDEX, 0]
        else:
            bmode = 6
            best_p = best_err1 < best_err0
            endpoint = [[0] * 4, [0] * 4]
            for c in range(4):
                lo, hi = mode6_tab[rgba8[c] + (0 if best_p else 1)]
                endpoint[0][c] = lo
                endpoint[1][c] = hi
            p01 = [int(best_p), int(best_p)]
            wts = [_BC7ENC_MODE_6_OPTIMAL_INDEX, _BC7ENC_MODE_6_OPTIMAL_INDEX]

        bc7 = _BC7_MODES[bmode]
        _, _, _, color_bits, alpha_bits, bweight_bits, bplanes, _, _, _ = bc7
        w.write(bmode + 1, 1 << bmode)
        if bmode == 5:
            w.write(2, 0)
        for channel in range(4):
            bit_count = color_bits if channel != 3 else alpha_bits
            w.write(bit_count, endpoint[0][channel])
            w.write(bit_count, endpoint[1][channel])
        if bmode == 6:
            w.write(2, (p01[1] << 1) | p01[0])
        for weight in wts[:bplanes]:
            w.write(bweight_bits - 1, weight)
            for _ in range(15):
                w.write(bweight_bits, weight)
        return bytes(output)

    bc7_mode_index = _UASTC_TO_BC7_MODES[mode_id]
    (_, pat_bits, bc7_endpoint_count, color_bits, alpha_bits, bweight_bits,
     bplanes, bsubsets, bp_bits, bsp_bits) = _BC7_MODES[bc7_mode_index]

    r.remove(trans_flags_bits)

    if plane_count == 2 and fmt == _LA:
        compsel = 3
    elif plane_count == 2:
        compsel = r.read(2)
    else:
        compsel = 0

    if mode_id == 7:
        uastc_pat, pattern_count = r.read(5), 19
    elif subset_count == 1:
        uastc_pat, pattern_count = 0, 1
    elif subset_count == 2:
        uastc_pat, pattern_count = r.read(5), 30
    else:
        uastc_pat, pattern_count = r.read(4), 11
    if uastc_pat >= pattern_count:
        raise OracleUastcError("block pattern is not valid")

    bc7_endpoints_per_channel = 2 * bsubsets
    bc7_channel_count = bc7_endpoint_count // bc7_endpoints_per_channel

    channel_count = {_RGB: 3, _RGBA: 4, _LA: 2}[fmt]
    endpoint_count = channel_count * subset_count * 2
    trit_quints, bit_vals = _decode_endpoints(r, range_index, endpoint_count)
    unquant = [0] * 18
    for i in range(endpoint_count):
        unquant[i] = _unquant_endpoint(trit_quints[i], bit_vals[i], range_index)
    pairs = _assemble_endpoint_pairs(fmt, unquant)
    endpoints = [[list(p[0]), list(p[1])] for p in pairs]
    while len(endpoints) < 3:
        endpoints.append([[0, 0, 0, 0], [0, 0, 0, 0]])

    raw = _decode_weights_raw(r, mode, uastc_pat)
    weights = [[0] * 16, [0] * 16]
    if plane_count == 1:
        weights[0] = _convert_weights_to_bc7(raw, uastc_weight_bits, bweight_bits)
    else:
        weights[0] = _convert_weights_to_bc7(raw[0::2], uastc_weight_bits, bweight_bits)
        weights[1] = _convert_weights_to_bc7(raw[1::2], uastc_weight_bits, bweight_bits)

    w.write(bc7_mode_index + 1, 1 << bc7_mode_index)

    bc7_anchors = [0]

    if bsubsets != 1:
        if mode_id == 1:
            index, _ = _PATTERNS_2_BC7_INDEX_INV[0]
            pattern = _PATTERNS_2_BC7[uastc_pat]
            anchors = _PATTERNS_2_BC7_ANCHORS[index]
            perm = [0, 0]
            bc7_pat = index
        elif mode_id == 7:
            index, p = _PATTERNS_2_3_BC7_INDEX_PERM[uastc_pat]
            perm = _PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS[p]
            pattern = _PATTERNS_2_3_BC7[uastc_pat]
            anchors = _PATTERNS_3_BC7_ANCHORS[index]
            bc7_pat = index
        elif subset_count == 2:
            index, inv = _PATTERNS_2_BC7_INDEX_INV[uastc_pat]
            pattern = _PATTERNS_2_BC7[uastc_pat]
            anchors = _PATTERNS_2_BC7_ANCHORS[index]
            perm = [1, 0] if inv else [0, 1]
            bc7_pat = index
        else:
            index, p = _PATTERNS_3_BC7_INDEX_PERM[uastc_pat]
            perm = _PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS[p]
            pattern = _PATTERNS_3_BC7[uastc_pat]
            anchors = _PATTERNS_3_BC7_ANCHORS[index]
            bc7_pat = index
        bc7_anchors = anchors

        w.write(pat_bits, bc7_pat)

        permuted = [endpoints[perm[i]] for i in range(len(perm))]
        endpoints = [
            [list(pair[0]), list(pair[1])] for pair in permuted
        ] + endpoints[len(perm):]

        weight_mask = (1 << bweight_bits) - 1
        weight_msb_mask = 1 << (bweight_bits - 1)
        invert_subset = [False] * 3
        for k, anchor in enumerate(anchors):
            invert_subset[k] = (weights[0][anchor] & weight_msb_mask) != 0
        for k in range(bsubsets):
            if invert_subset[k]:
                endpoints[k][0], endpoints[k][1] = endpoints[k][1], endpoints[k][0]
        for i in range(16):
            if invert_subset[pattern[i]]:
                weights[0][i] = ~weights[0][i] & weight_mask
    else:
        weight_mask = (1 << bweight_bits) - 1
        weight_msb_mask = 1 << (bweight_bits - 1)
        if plane_count == 1:
            if weights[0][0] & weight_msb_mask:
                endpoints[0][0], endpoints[0][1] = endpoints[0][1], endpoints[0][0]
                weights[0] = [~x & weight_mask for x in weights[0]]
        else:
            invert_plane = [
                bool(weights[0][0] & weight_msb_mask),
                bool(weights[1][0] & weight_msb_mask),
            ]
            pair = endpoints[0]
            for e in pair:
                e[compsel], e[3] = e[3], e[compsel]
            if invert_plane[0]:
                pair[0], pair[1] = pair[1], pair[0]
            if invert_plane[0] != invert_plane[1]:
                pair[0][3], pair[1][3] = pair[1][3], pair[0][3]
            for k in range(2):
                if invert_plane[k]:
                    weights[k] = [~x & weight_mask for x in weights[k]]
            w.write(2, (compsel + 1) & 0b11)
            if bc7_mode_index == 4:
                w.write(1, 0)

    sub_endpoints = endpoints[:bsubsets]

    p01 = [[0, 0], [0, 0], [0, 0]]
    if bp_bits != 0:
        for k in range(bsubsets):
            p01[k] = _determine_pbits(
                bc7_channel_count, color_bits, sub_endpoints[k], shared=False, rnd=rnd
            )
    elif bsp_bits != 0:
        for k in range(bsubsets):
            p01[k] = _determine_pbits(
                bc7_channel_count, color_bits, sub_endpoints[k], shared=True, rnd=rnd
            )
    else:
        def scale(e, bits):
            return (e * ((1 << bits) - 1) + 127) // 255

        for pair in sub_endpoints:
            for e in pair:
                for c in range(3):
                    e[c] = scale(e[c], color_bits)
                e[3] = scale(e[3], alpha_bits)

    for channel in range(bc7_channel_count):
        bit_count = color_bits if channel != 3 else alpha_bits
        for pair in sub_endpoints:
            w.write(bit_count, pair[0][channel])
            w.write(bit_count, pair[1][channel])

    if bp_bits != 0:
        for k in range(bsubsets):
            w.write(2, (p01[k][1] << 1) | p01[k][0])
    elif bsp_bits != 0:
        w.write(2, (p01[1][0] << 1) | p01[0][0])

    bit_counts = [bweight_bits] * 16
    for anchor in bc7_anchors:
        bit_counts[anchor] -= 1
    for plane_weights in weights[:bplanes]:
        for i in range(16):
            w.write(bit_counts[i], plane_weights[i])

    return bytes(output)

