"""BasisLZ / ETC1S host front-end: codebooks and per-block index streams.

Port of `basisu_rs_tpu/container/etc1s_frontend.py`.  This is the sequential
part of ETC1S decoding: Huffman-coded codebooks and a raster-order
prediction state machine, run once per slice on the host.  It emits the
endpoint codebook (uint8 [E, 4]: r5, g5, b5, inten3), the selector codebook
(uint8 [S, 4] row bytes) and each slice's uint16 (endpoint, selector) index
streams, which the device kernels K6-K9 (`ops/etc1s.py`) consume.

Two front-ends, as in the JAX package:
  - native (the default): the C++ of `etc1s_frontend.cpp`, which
    `ops.build.host_library` builds with g++ at first use.  A missing g++ or
    a failed build raises; there is no quiet fall-back to the Python code.
    Its errors carry the C++ code's messages (`NATIVE_ERRORS`).
  - plain (`native=False`): the Python state machine below, the version the
    tests hold the native one against.  Its errors carry the reference's
    messages ("left predictor at column 0", ...).
Both raise `Etc1sError`, a `BasisError`.

Reference behaviour (src/basis_lz/mod.rs):
  - endpoint codebook DPCM decode: mod.rs:461-516
  - selector codebook decode: mod.rs:524-583
  - block stream state machine (endpoint pred symbols, RLE, selector
    history buffer with approximate move-to-front): mod.rs:188-458
  - VLC decode: mod.rs:585-608
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..base import BasisError
from ..ops import build
from ..utils.bitio import BitReaderLsb
from ..utils.profiling import count
from .huffman import HuffmanError, read_huffman_table

ENDPOINT_PRED_TOTAL_SYMBOLS = 4 * 4 * 4 * 4 + 1
ENDPOINT_PRED_REPEAT_LAST_SYMBOL = ENDPOINT_PRED_TOTAL_SYMBOLS - 1
ENDPOINT_PRED_MIN_REPEAT_COUNT = 3
ENDPOINT_PRED_COUNT_VLC_BITS = 4

CR_ENDPOINT_PRED_INDEX = 2

SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH = 3
SELECTOR_HISTORY_BUF_RLE_COUNT_BITS = 6
SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL = 1 << SELECTOR_HISTORY_BUF_RLE_COUNT_BITS

SOURCE = Path(__file__).resolve().parent / "etc1s_frontend.cpp"

# error codes of etc1s_frontend.cpp
NATIVE_ERRORS = {
    -2: "Code lengths are invalid, codes don't fit into 16 bits",
    -3: "No matching code found in the decoding table",
    -4: "invalid repeat code in code-length stream",
    -5: "VLC overflow",
    -6: "Global/hybrid selector codebooks are not supported",
    -7: "predictor references out-of-bounds neighbor",
    -8: "history buffer reference invalid",
    -9: "decoded index out of codebook range",
}
NATIVE_TABLES_ERROR = "failed to parse ETC1S Huffman tables"


class Etc1sError(BasisError):
    """ETC1S/BasisLZ decode failure.

    Covers the reference's `Err` sites (unsupported codebook flavours, VLC
    overflow) and its `assert!`/panic sites (prediction-edge violations
    mod.rs:303-310, out-of-range decoded indices mod.rs:443-444), which
    abort the process in the reference and raise this catchable error here
    (COMPAT.md item 5)."""


# ---------------------------------------------------------------------------
# plain front-end
# ---------------------------------------------------------------------------


def decode_vlc(reader: BitReaderLsb, chunk_bits: int) -> int:
    """Variable-length count decode (mod.rs:585-608)."""
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
            raise Etc1sError("VLC overflow")


def decode_endpoints(num_endpoints: int, data: bytes) -> np.ndarray:
    """-> uint8 [E, 4]: (r5, g5, b5, inten3) per codebook entry."""
    reader = BitReaderLsb(data)
    models = [read_huffman_table(reader) for _ in range(3)]
    inten_model = read_huffman_table(reader)
    grayscale = reader.read_bool()

    out = np.zeros((num_endpoints, 4), np.uint8)
    prev_color5 = [16, 16, 16]
    prev_inten = 0
    for e in range(num_endpoints):
        inten = (inten_model.decode_symbol(reader) + prev_inten) & 7
        prev_inten = inten
        out[e, 3] = inten
        for c in range(1 if grayscale else 3):
            p = prev_color5[c]
            # the delta model is chosen by the previous value's range (mod.rs:487-498)
            model = models[0 if p <= 9 else (1 if p <= 21 else 2)]
            delta = model.decode_symbol(reader)
            v = (p + delta) & 31
            out[e, c] = v
            prev_color5[c] = v
        if grayscale:
            out[e, 1] = out[e, 0]
            out[e, 2] = out[e, 0]
    return out


def decode_selectors(num_selectors: int, data: bytes) -> np.ndarray:
    """-> uint8 [S, 4]: the four row bytes (2-bit selectors, x at bits 2x)
    per codebook entry (mod.rs:524-583)."""
    reader = BitReaderLsb(data)
    global_cb = reader.read_bool()
    hybrid_cb = reader.read_bool()
    raw = reader.read_bool()

    if global_cb:
        raise Etc1sError("Global selector codebooks are not supported")
    if hybrid_cb:
        raise Etc1sError("Hybrid selector codebooks are not supported")

    out = np.zeros((num_selectors, 4), np.uint8)
    if not raw:
        model = read_huffman_table(reader)
        prev = [0, 0, 0, 0]
        for s in range(num_selectors):
            for y in range(4):
                if s == 0:
                    cur = reader.read(8)
                else:
                    cur = model.decode_symbol(reader) ^ prev[y]
                prev[y] = cur
                out[s, y] = cur
    else:
        for s in range(num_selectors):
            for y in range(4):
                out[s, y] = reader.read(8)
    return out


# ---------------------------------------------------------------------------
# native front-end
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    p, n, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    for name, res, args in (
        ("etc1s_decode_endpoints", i, [p, n, i, p]),
        ("etc1s_decode_selectors", i, [p, n, i, p]),
        ("etc1s_create", p, [p, n, i, i, i]),
        ("etc1s_destroy", None, [p]),
        ("etc1s_history_size", ctypes.c_uint32, [p]),
        ("etc1s_decode_slice", i, [p, p, n, i, i, p, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _bytes(data) -> np.ndarray:
    """A uint8 view of any buffer (bytes, memoryview, numpy), no copy."""
    return np.frombuffer(data, np.uint8)


def _check(rc: int) -> None:
    if rc != 0:
        raise Etc1sError(NATIVE_ERRORS.get(rc, f"native error {rc}"))


def decode_endpoints_native(num_endpoints: int, data) -> np.ndarray:
    arr = _bytes(data)
    out = np.zeros((num_endpoints, 4), np.uint8)
    _check(_lib().etc1s_decode_endpoints(arr.ctypes.data, arr.size, num_endpoints, out.ctypes.data))
    return out


def decode_selectors_native(num_selectors: int, data) -> np.ndarray:
    arr = _bytes(data)
    out = np.zeros((num_selectors, 4), np.uint8)
    _check(_lib().etc1s_decode_selectors(arr.ctypes.data, arr.size, num_selectors, out.ctypes.data))
    return out


class _NativeModels:
    """Owns the C++ decoder handle: the four Huffman models and the history
    size shared by every slice of a file."""

    def __init__(self, tables, num_endpoints: int, num_selectors: int, is_video: bool):
        self._lib = _lib()
        arr = _bytes(tables)
        self._h = self._lib.etc1s_create(arr.ctypes.data, arr.size, num_endpoints, num_selectors, int(is_video))
        if not self._h:
            raise Etc1sError(NATIVE_TABLES_ERROR)

    @property
    def history_size(self) -> int:
        return int(self._lib.etc1s_history_size(self._h))

    def decode_slice(self, nbx: int, nby: int, data, ep: np.ndarray, sel: np.ndarray) -> None:
        """One slice into ep and sel; counts `huff_symbols`, the Huffman
        symbols it decoded, and `huff_root_symbols`, those the C++ table's
        root lookup resolved without a subtable."""
        arr = _bytes(data)
        counts = (ctypes.c_uint64 * 2)()
        _check(self._lib.etc1s_decode_slice(self._h, arr.ctypes.data, arr.size, nbx, nby, ep.ctypes.data,
                                            sel.ctypes.data, counts))
        count("huff_symbols", counts[0])
        count("huff_root_symbols", counts[1])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.etc1s_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# the decoder of a file
# ---------------------------------------------------------------------------


@dataclass
class Etc1sSlice:
    """One slice's decoded index streams, ready for the device."""

    num_blocks_x: int
    num_blocks_y: int
    endpoint_index: np.ndarray  # uint16 [num_blocks]
    selector_index: np.ndarray  # uint16 [num_blocks]


class Etc1sDecoder:
    """Codebooks and Huffman models shared by every slice of a file
    (mod.rs:50-95).  native=True (the default) runs the C++ front-end,
    native=False the plain Python one."""

    def __init__(
        self,
        num_endpoints: int,
        num_selectors: int,
        endpoints_data,
        selectors_data,
        tables_data,
        is_video: bool = False,
        native: bool = True,
    ):
        self.is_video = is_video
        self._native = None
        if native:
            self.endpoints = decode_endpoints_native(num_endpoints, endpoints_data)
            self.selectors = decode_selectors_native(num_selectors, selectors_data)
            self._native = _NativeModels(tables_data, num_endpoints, num_selectors, is_video)
            self.selector_history_buffer_size = self._native.history_size
            return
        try:
            self.endpoints = decode_endpoints(num_endpoints, bytes(endpoints_data))
            self.selectors = decode_selectors(num_selectors, bytes(selectors_data))
            reader = BitReaderLsb(bytes(tables_data))
            self.endpoint_pred_model = read_huffman_table(reader)
            self.delta_endpoint_model = read_huffman_table(reader)
            self.selector_model = read_huffman_table(reader)
            self.selector_history_buf_rle_model = read_huffman_table(reader)
        except HuffmanError as e:
            raise Etc1sError(str(e)) from None
        self.selector_history_buffer_size = reader.read(13)

    def decode_slice(self, num_blocks_x: int, num_blocks_y: int, data, out=None) -> Etc1sSlice:
        """Run the sequential prediction state machine over one slice's
        bytes (mod.rs:188-458).  out: an optional (endpoint, selector) pair
        of uint16 [num_blocks] arrays to fill (views into a larger buffer
        let a file decode every slice into one array)."""
        n = num_blocks_x * num_blocks_y
        ep, sel = out if out is not None else (np.zeros(n, np.uint16), np.zeros(n, np.uint16))
        if ep.shape != (n,) or sel.shape != (n,) or ep.dtype != np.uint16 or sel.dtype != np.uint16:
            raise ValueError(f"out must be two uint16 [{n}] arrays")
        if self._native is not None:
            if not (ep.flags.c_contiguous and sel.flags.c_contiguous):
                raise ValueError("out arrays must be contiguous")
            self._native.decode_slice(num_blocks_x, num_blocks_y, data, ep, sel)
        else:
            try:
                self._decode_slice_plain(num_blocks_x, num_blocks_y, bytes(data), ep, sel)
            except HuffmanError as e:
                raise Etc1sError(str(e)) from None
        return Etc1sSlice(num_blocks_x, num_blocks_y, ep, sel)

    def _decode_slice_plain(self, num_blocks_x: int, num_blocks_y: int, data: bytes, ep_out, sel_out) -> None:
        reader = BitReaderLsb(data)
        num_endpoints = len(self.endpoints)
        num_selectors = len(self.selectors)
        n = num_blocks_x * num_blocks_y

        # per-column predictors for two block rows (mod.rs:213-217)
        pred_ep = np.zeros((2, num_blocks_x), np.uint16)
        pred_bits_row = np.zeros((2, num_blocks_x), np.uint8)

        history_rle_sym = self.selector_history_buffer_size + num_selectors
        cur_selector_rle_count = 0
        cur_pred_bits = 0
        prev_pred_sym = 0
        pred_repeat_count = 0
        prev_endpoint_index = 0

        if self.is_video:
            # the reference allocates this zeroed per decode_blocks call
            # (mod.rs:236-237): the previous frame does not carry over
            # between slices
            prev_frame = np.zeros((n, 2), np.uint16)
            cur_frame = prev_frame

        # approximate move-to-front buffer (mod.rs:610-656)
        hist_size = self.selector_history_buffer_size
        hist = [0] * hist_size
        rover = hist_size // 2

        bi = 0
        for by in range(num_blocks_y):
            cur_row = by & 1
            for bx in range(num_blocks_x):
                if bx & 1 == 0:
                    if by & 1 == 0:
                        if pred_repeat_count != 0:
                            pred_repeat_count -= 1
                            cur_pred_bits = prev_pred_sym
                        else:
                            sym = self.endpoint_pred_model.decode_symbol(reader)
                            if sym == ENDPOINT_PRED_REPEAT_LAST_SYMBOL:
                                pred_repeat_count = (
                                    decode_vlc(reader, ENDPOINT_PRED_COUNT_VLC_BITS)
                                    + ENDPOINT_PRED_MIN_REPEAT_COUNT
                                    - 1
                                )
                                cur_pred_bits = prev_pred_sym
                            else:
                                cur_pred_bits = sym
                                prev_pred_sym = cur_pred_bits
                        pred_bits_row[cur_row ^ 1, bx] = cur_pred_bits >> 4
                    else:
                        cur_pred_bits = int(pred_bits_row[cur_row, bx])

                pred = cur_pred_bits & 3
                cur_pred_bits >>= 2

                if pred == 0:
                    if bx == 0:
                        raise Etc1sError("left predictor at column 0")
                    endpoint_index = prev_endpoint_index
                elif pred == 1:
                    if by == 0:
                        raise Etc1sError("upper predictor at row 0")
                    endpoint_index = int(pred_ep[cur_row ^ 1, bx])
                elif pred == 2:
                    if self.is_video:
                        endpoint_index = int(prev_frame[bi, 0])
                    else:
                        if bx == 0 or by == 0:
                            raise Etc1sError("upper-left predictor at edge")
                        endpoint_index = int(pred_ep[cur_row ^ 1, bx - 1])
                else:
                    delta = self.delta_endpoint_model.decode_symbol(reader)
                    endpoint_index = delta + prev_endpoint_index
                    if endpoint_index >= num_endpoints:
                        endpoint_index -= num_endpoints

                pred_ep[cur_row, bx] = endpoint_index
                prev_endpoint_index = endpoint_index

                if not self.is_video or pred != CR_ENDPOINT_PRED_INDEX:
                    if cur_selector_rle_count > 0:
                        cur_selector_rle_count -= 1
                        selector_sym = num_selectors
                    else:
                        sym = self.selector_model.decode_symbol(reader)
                        if sym == history_rle_sym:
                            run_sym = self.selector_history_buf_rle_model.decode_symbol(reader)
                            if run_sym == SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1:
                                cur_selector_rle_count = SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH + decode_vlc(reader, 7)
                            else:
                                cur_selector_rle_count = SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH + run_sym
                            cur_selector_rle_count -= 1
                            selector_sym = num_selectors
                        else:
                            selector_sym = sym

                    if selector_sym >= num_selectors:
                        if hist_size == 0:
                            raise Etc1sError("history reference with empty history buffer")
                        history_buf_index = selector_sym - num_selectors
                        if history_buf_index >= hist_size:
                            raise Etc1sError("history buffer index out of range")
                        selector_index = hist[history_buf_index]
                        if history_buf_index != 0:
                            half = history_buf_index // 2
                            hist[half], hist[history_buf_index] = hist[history_buf_index], hist[half]
                    else:
                        if hist_size > 0:
                            hist[rover] = selector_sym
                            rover += 1
                            if rover == hist_size:
                                rover = hist_size // 2
                        selector_index = selector_sym
                else:
                    selector_index = int(prev_frame[bi, 1])

                if self.is_video:
                    cur_frame[bi, 0] = endpoint_index
                    cur_frame[bi, 1] = selector_index

                if endpoint_index >= num_endpoints or selector_index >= num_selectors:
                    raise Etc1sError("decoded index out of codebook range")
                ep_out[bi] = endpoint_index
                sel_out[bi] = selector_index
                bi += 1
