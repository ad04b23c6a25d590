"""PyTorch port: the ETC1S host front-end, on the CPU.

The port's own front-ends (container/etc1s_frontend.py: the C++ of
etc1s_frontend.cpp, built with g++ at first use, and the plain Python one)
against the JAX package's front-end and the reference-transcribed oracle
(tests/oracle_etc1s.py) on the fuzz streams of tests/test_etc1s_oracle.py
(history buffer, RLE runs, texture video), bit-exact; codebook flavours the
writer does not emit (Huffman-coded selectors, grayscale endpoints); the
error messages of each path against the same path of the JAX package; the
C++ symbol decoder on code lengths of 1 to 16 bits (either side of its 12-bit
root), its refills, its tail, truncated streams and its symbol counters; and
the Huffman tables and bit I/O they rest on (as tests/test_huffman.py)."""

import heapq
from functools import lru_cache

import numpy as np
import pytest

import basisu_rs_tpu.container.basis as jb
import basisu_rs_tpu.container.etc1s_frontend as jf
import basisu_rs_tpu.container.huffman as jh
import basisu_rs_tpu.container.writer as jw
import basisu_rs_tpu_torch.container.basis as tb
from basisu_rs_tpu_torch.api import BasisError
from basisu_rs_tpu_torch.container.etc1s_frontend import NATIVE_ERRORS, Etc1sDecoder, Etc1sError
from basisu_rs_tpu_torch.container.huffman import HuffmanDecodingTable, HuffmanError, read_huffman_table
from basisu_rs_tpu_torch.container.writer import (
    CanonicalEncoder,
    encode_etc1s_endpoint_codebook,
    encode_etc1s_selector_codebook,
    equal_length_sizes,
    _write_vlc,
    write_etc1s_basis_fuzz,
    write_huffman_table,
)
from basisu_rs_tpu_torch.utils import profiling
from basisu_rs_tpu_torch.utils.bitio import BitReaderLsb, BitWriterLsb
from oracle_etc1s import OracleEtc1sDecoder, oracle_make_decoder
from torch_cases import etc1s_codebooks as codebooks

FRONTENDS = [True, False]  # native, plain
FUZZ_CASES = [(0, 0, False), (1, 16, False), (2, 64, False), (3, 8, True), (4, 64, True), (5, 1, False)]


def sections(buf):
    h = tb.read_header(buf)
    return (h.total_endpoints, h.total_selectors, buf[h.endpoint_cb_file_ofs : h.endpoint_cb_file_ofs + h.endpoint_cb_file_size],
            buf[h.selector_cb_file_ofs : h.selector_cb_file_ofs + h.selector_cb_file_size],
            buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size])


@pytest.mark.parametrize("native", FRONTENDS, ids=["native", "plain"])
@pytest.mark.parametrize("seed,hist,video", FUZZ_CASES)
def test_fuzz_stream_matches_jax_and_oracle(seed, hist, video, native):
    rng = np.random.default_rng(100 + seed)
    e, s = int(rng.integers(2, 300)), int(rng.integers(2, 200))
    nbx, nby = int(rng.integers(1, 24)), int(rng.integers(1, 20))
    endpoints, selectors = codebooks(rng, e, s)
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video)
    assert buf == jw.write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video)[0]

    h = tb.read_header(buf)
    data = tb.read_slice_descs(buf, h)[0].data(buf)
    dec = tb.make_etc1s_decoder(h, buf, native=native)
    assert (dec._native is not None) == native and dec.is_video == video
    sl = dec.decode_slice(nbx, nby, data)
    assert sl.endpoint_index.dtype == sl.selector_index.dtype == np.uint16

    jdec = jb.make_etc1s_decoder(jb.read_header(buf), buf)
    jsl = jdec.decode_slice(nbx, nby, bytes(data))
    pairs = oracle_make_decoder(buf).decode_blocks(nbx, nby, bytes(data))
    for got, jax_stream, k in ((sl.endpoint_index, jsl.endpoint_index, 0), (sl.selector_index, jsl.selector_index, 1)):
        np.testing.assert_array_equal(got, jax_stream)
        np.testing.assert_array_equal(got, [p[k] for p in pairs])
    np.testing.assert_array_equal(sl.endpoint_index, exp_ep)
    np.testing.assert_array_equal(sl.selector_index, exp_sel)
    np.testing.assert_array_equal(dec.endpoints, endpoints)
    np.testing.assert_array_equal(dec.selectors, selectors)
    assert dec.selector_history_buffer_size == jdec.selector_history_buffer_size == hist


@pytest.fixture(scope="module")
def deep_file():
    rng = np.random.default_rng(31)
    endpoints, selectors = codebooks(rng, 4096, 5000)  # equal-length codes of 12 and 13 bits
    return write_etc1s_basis_fuzz(endpoints, selectors, 40, 10, 16, seed=31)


@pytest.mark.parametrize("native", FRONTENDS, ids=["native", "plain"])
def test_deep_huffman_tables(deep_file, native):
    # every endpoint delta code is 12 bits, which the C++ table's root (as
    # wide as the longest code, at most 12 bits) resolves alone; every
    # selector code is 13 bits, past the root: each takes a subtable
    buf, exp_ep, exp_sel = deep_file
    dec = Etc1sDecoder(*sections(buf), native=native)
    sl = dec.decode_slice(40, 10, tb.read_slice_descs(buf, tb.read_header(buf))[0].data(buf))
    np.testing.assert_array_equal(sl.endpoint_index, exp_ep)
    np.testing.assert_array_equal(sl.selector_index, exp_sel)


def test_decode_into_views_of_one_buffer():
    rng = np.random.default_rng(12)
    endpoints, selectors = codebooks(rng, 30, 20)
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(endpoints, selectors, 5, 3, 8, seed=12)
    host = np.zeros((2, 20), np.uint16)
    dec = Etc1sDecoder(*sections(buf))
    dec.decode_slice(5, 3, tb.read_slice_descs(buf, tb.read_header(buf))[0].data(buf), out=(host[0, 2:17], host[1, 2:17]))
    np.testing.assert_array_equal(host[0, 2:17], exp_ep)
    np.testing.assert_array_equal(host[1, 2:17], exp_sel)
    assert not host[:, :2].any() and not host[:, 17:].any()


# ---------------------------------------------------------------------------
# the C++ symbol decoder: root widths either side of its 12-bit cap, the bit
# buffer's refills and its tail, and its symbol counters
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _coded_books(e, s):
    """(endpoint codebook bytes, selector codebook bytes) of seeded codebooks."""
    endpoints, selectors = codebooks(np.random.default_rng(e * 7 + s), e, s)
    return encode_etc1s_endpoint_codebook(endpoints), encode_etc1s_selector_codebook(selectors)


def _coded_slice(delta_sizes, sel_sizes, nbx, nby, seed, pred_sizes=None):
    """(decoder args, payload) of one slice whose blocks all take pred 3 (the
    group symbol 255): each block an endpoint delta and a selector, drawn
    uniformly over the tables' symbols (E = len(delta_sizes), S =
    len(sel_sizes)), coded with these code lengths."""
    e, s = len(delta_sizes), len(sel_sizes)
    tw = BitWriterLsb()
    pred_enc = write_huffman_table(tw, pred_sizes or equal_length_sizes(257))
    delta_enc = write_huffman_table(tw, delta_sizes)
    sel_enc = write_huffman_table(tw, sel_sizes)
    write_huffman_table(tw, equal_length_sizes(64))
    tw.write(13, 0)
    rng = np.random.default_rng(seed)
    w = BitWriterLsb()
    prev = 0
    for by in range(nby):
        for bx in range(nbx):
            if bx % 2 == 0 and by % 2 == 0:
                pred_enc.encode(w, 255)
            ep = int(rng.integers(0, e))
            delta_enc.encode(w, (ep - prev) % e)
            prev = ep
            sel_enc.encode(w, int(rng.integers(0, s)))
    return (e, s, *_coded_books(e, s), tw.getvalue()), w.getvalue()


def _streams_of_every_frontend(args, nbx, nby, payload):
    """[native, plain, JAX, oracle] (endpoint, selector) index streams of
    one slice; each front-end's error message in its place where it raises."""
    out = []
    for decode in (lambda: Etc1sDecoder(*args).decode_slice(nbx, nby, payload),
                   lambda: Etc1sDecoder(*args, native=False).decode_slice(nbx, nby, payload),
                   lambda: jf.Etc1sDecoder(*args).decode_slice(nbx, nby, bytes(payload))):
        try:
            sl = decode()
            out.append((sl.endpoint_index.tolist(), sl.selector_index.tolist()))
        except (BasisError, ValueError) as exc:
            out.append(str(exc))
    try:
        pairs = OracleEtc1sDecoder(*args).decode_blocks(nbx, nby, bytes(payload))
        out.append(([p[0] for p in pairs], [p[1] for p in pairs]))
    except Exception as exc:  # the reference's assert sites
        out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("bits", [9, 11, 12, 13, 16])
def test_equal_length_codes_either_side_of_the_root_cap(bits):
    # every delta and selector code `bits` long, E = S = 2^(bits-1) + 1 (the
    # shortest such codes), or for 16 bits the 16,383 symbols a table's 14-bit
    # count allows (an incomplete code); the root holds codes up to 12 bits,
    # 13 and 16 take a subtable
    n = min((1 << (bits - 1)) + 1, (1 << 14) - 1)
    assert bits == 16 or equal_length_sizes(n) == [bits] * n
    args, payload = _coded_slice([bits] * n, [bits] * n, 24, 20, seed=bits)
    native, plain, jax_stream, oracle = _streams_of_every_frontend(args, 24, 20, payload)
    assert native == plain == jax_stream == oracle


SKEWED = list(range(1, 16)) + [16, 16]  # Kraft-complete, codes of 1 to 16 bits


@pytest.mark.parametrize("seed", [1, 2])
def test_skewed_codes_of_1_to_16_bits(seed):
    args, payload = _coded_slice(SKEWED, SKEWED[::-1], 24, 20, seed=seed, pred_sizes=[0] * 255 + [1])
    native, plain, jax_stream, oracle = _streams_of_every_frontend(args, 24, 20, payload)
    assert native == plain == jax_stream == oracle
    assert len(set(native[0])) == len(set(native[1])) == len(SKEWED)  # every code length decoded


@pytest.mark.parametrize("pad", range(9))
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (7, 5)])
def test_last_symbol_ends_in_each_of_the_last_bytes(shape, pad):
    # `pad` bytes of ones after the last code: the final refills load the
    # stream's last 0-8 bytes and zero bytes past them (a 1x1 slice is under
    # 8 bytes long in all); ones would decode if the reader ran past its data
    args, payload = _coded_slice(SKEWED, equal_length_sizes(300), *shape, seed=pad)
    native, plain, jax_stream, oracle = _streams_of_every_frontend(args, *shape, payload + b"\xff" * pad)
    assert native == plain == jax_stream == oracle
    assert [native, plain] == _streams_of_every_frontend(args, *shape, payload)[:2]


@pytest.mark.parametrize("cut", [1, 3, 9, 40, 150, 233, 280, 305, 314])
def test_truncated_streams(cut):
    # past the end the reader gives zero bits, which decode to symbol 0: group
    # symbol 0 puts pred 0 (left) at column 0, which each path refuses with the
    # message its JAX counterpart gives (a cut inside a group symbol may give
    # another pred); a cut in the last rows decodes to the end (of 315 bytes)
    args, payload = _coded_slice(equal_length_sizes(2049), equal_length_sizes(2049), 12, 8, seed=cut)
    assert cut < len(payload)
    native, plain, jax_stream, oracle = _streams_of_every_frontend(args, 12, 8, payload[:cut])
    jax_plain = jf.Etc1sDecoder(*args, use_native=False)
    try:
        sl = jax_plain.decode_slice(12, 8, bytes(payload[:cut]))
        jax_plain = (sl.endpoint_index.tolist(), sl.selector_index.tolist())
    except ValueError as exc:
        jax_plain = str(exc)
    assert native == jax_stream and plain == jax_plain
    if isinstance(native, str):
        assert native in NATIVE_ERRORS.values() and isinstance(plain, str) and isinstance(oracle, str)
    else:
        assert native == plain == oracle


def _run_block(repeat):
    """(decoder args, payload, nbx, nby): every code 16 bits, and block (2, 0)
    takes its group symbol, its delta, the selector-RLE symbol and run symbol
    63 (64 bits, past the 56 of the block's refill), then a VLC of 5 chunks
    (40 bits); repeat=True makes the group symbol the pred-repeat symbol and
    a VLC of 8 chunks (40 bits) after it: 144 bits in one block."""
    e, s, hist = 8, 6, 4
    tw = BitWriterLsb()
    pred_enc, delta_enc, sel_enc, rle_enc = (write_huffman_table(tw, [16] * k) for k in (257, e, s + hist + 1, 64))
    tw.write(13, hist)
    w = BitWriterLsb()
    pred_enc.encode(w, 255)  # blocks (0, 0), (1, 0): pred 3, fresh selectors
    for k in range(2):
        delta_enc.encode(w, 3 + k)
        sel_enc.encode(w, 1 + k)
    if repeat:  # block (2, 0): repeat the group symbol
        pred_enc.encode(w, 256)
        _write_vlc(w, (1 << 31) + 5, 4)
    else:
        pred_enc.encode(w, 255)
    delta_enc.encode(w, 5)
    sel_enc.encode(w, s + hist)  # a run of history entry 0
    rle_enc.encode(w, 63)
    _write_vlc(w, (1 << 30) + 9, 7)
    for k in range(6 * 2 - 3):  # the other blocks: deltas, their selectors from the run
        if k == 1 and not repeat:
            pred_enc.encode(w, 255)  # block (4, 0)'s group
        delta_enc.encode(w, 1)
    return (e, s, *_coded_books(e, s), tw.getvalue()), w.getvalue(), 6, 2


@pytest.mark.parametrize("repeat", [False, True], ids=["symbol_and_run", "repeat_and_run"])
def test_pred_repeat_and_selector_run_in_one_block(repeat):
    args, payload, nbx, nby = _run_block(repeat)
    native, plain, jax_stream, oracle = _streams_of_every_frontend(args, nbx, nby, payload)
    assert native == plain == jax_stream == oracle
    assert native[0][:4] == [3, 7, 4, 5] and native[1][:3] == [1, 2, 0]


def test_symbol_counters():
    # counted by the C++ slice decoder, added to the recorder's request:
    # 11-bit codes all resolve in the root; 13-bit delta and selector codes
    # take a subtable, the 1-bit group symbols do not
    counted = {}
    for bits in (11, 13):
        n = (1 << (bits - 1)) + 1
        args, payload = _coded_slice(equal_length_sizes(n), equal_length_sizes(n), 10, 6, seed=bits,
                                     pred_sizes=[0] * 255 + [1])
        dec = Etc1sDecoder(*args)
        profiling.clear()
        profiling.enable()
        try:
            with profiling.span("frontend.slice"):
                dec.decode_slice(10, 6, payload)
            rec = profiling.records()
        finally:
            profiling.disable()
            profiling.clear()
        counted[bits] = rec.total("huff_symbols"), rec.total("huff_root_symbols")
    groups, blocks = 5 * 3, 10 * 6
    assert counted[11] == (groups + 2 * blocks, groups + 2 * blocks)
    assert counted[13] == (groups + 2 * blocks, groups)
    # the plain front-end has no root table and counts nothing
    profiling.clear()
    profiling.enable()
    try:
        Etc1sDecoder(*args, native=False).decode_slice(10, 6, payload)
        assert profiling.records() is None or profiling.records().total("huff_symbols") == 0
    finally:
        profiling.disable()
        profiling.clear()


# ---------------------------------------------------------------------------
# codebook flavours the writer does not emit
# ---------------------------------------------------------------------------


def _huffman_selector_codebook(selectors):
    """global 0, hybrid 0, raw 0: a 256-symbol model, the first entry's row
    bytes raw, then each row byte as its XOR with the previous entry's."""
    w = BitWriterLsb()
    for bit in (0, 0, 0):
        w.write(1, bit)
    enc = write_huffman_table(w, equal_length_sizes(256))
    prev = [0, 0, 0, 0]
    for k, row in enumerate(selectors):
        for y in range(4):
            if k == 0:
                w.write(8, int(row[y]))
            else:
                enc.encode(w, int(row[y]) ^ prev[y])
            prev[y] = int(row[y])
    return w.getvalue()


def _grayscale_endpoint_codebook(endpoints):
    """grayscale 1: one colour delta an entry, G = B = R."""
    w = BitWriterLsb()
    color_enc = [write_huffman_table(w, equal_length_sizes(32)) for _ in range(3)]
    inten_enc = write_huffman_table(w, equal_length_sizes(8))
    w.write(1, 1)
    prev, prev_inten = 16, 0
    for e in endpoints:
        inten_enc.encode(w, (int(e[3]) - prev_inten) & 7)
        prev_inten = int(e[3])
        color_enc[0 if prev <= 9 else (1 if prev <= 21 else 2)].encode(w, (int(e[0]) - prev) & 31)
        prev = int(e[0])
    return w.getvalue()


def _tables(e, s, hist=0):
    tw = BitWriterLsb()
    encs = [write_huffman_table(tw, equal_length_sizes(n)) for n in (257, e, s + hist + 1, 64)]
    tw.write(13, hist)
    return tw.getvalue(), encs


@pytest.mark.parametrize("native", FRONTENDS, ids=["native", "plain"])
def test_huffman_coded_and_grayscale_codebooks(native):
    rng = np.random.default_rng(13)
    endpoints, selectors = codebooks(rng, 70, 60)
    endpoints[:, 1] = endpoints[:, 2] = endpoints[:, 0]
    ep_cb, sel_cb = _grayscale_endpoint_codebook(endpoints), _huffman_selector_codebook(selectors)
    tables, _ = _tables(70, 60)
    dec = Etc1sDecoder(70, 60, ep_cb, sel_cb, tables, native=native)
    jdec = jf.Etc1sDecoder(70, 60, ep_cb, sel_cb, tables, use_native=native)
    for got, jax_book, ref in ((dec.endpoints, jdec.endpoints, endpoints), (dec.selectors, jdec.selectors, selectors)):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jax_book)


# ---------------------------------------------------------------------------
# errors, path by path
# ---------------------------------------------------------------------------


def _error_case(case):
    """(decoder args, slice (nbx, nby, payload) or None): one fault each."""
    rng = np.random.default_rng(7)
    endpoints, selectors = codebooks(rng, 4, 4)
    ep_cb, sel_cb = encode_etc1s_endpoint_codebook(endpoints), encode_etc1s_selector_codebook(selectors)
    tables, (pred_enc, delta_enc, sel_enc, _) = _tables(4, 4)
    w = BitWriterLsb()
    if case.startswith("pred"):  # block (0, 0) takes the symbol's low 2 bits: 0, 1 or 2
        pred_enc.encode(w, int(case[-1]))
        return (4, 4, ep_cb, sel_cb, tables), (1, 1, w.getvalue())
    if case == "empty_history":  # selector symbol S names history entry 0 of none
        pred_enc.encode(w, 255)
        delta_enc.encode(w, 1)
        sel_enc.encode(w, 4)
        return (4, 4, ep_cb, sel_cb, tables), (1, 1, w.getvalue())
    if case == "endpoint_range":  # a 16-symbol delta model: delta 9 wraps to 5 >= E
        tables, (pred_enc, delta_enc, _, _) = _tables(16, 4)
        pred_enc.encode(w, 255)
        delta_enc.encode(w, 9)
        return (4, 4, ep_cb, sel_cb, tables), (1, 1, w.getvalue())
    if case == "vlc_overflow":  # the repeat symbol, then a count whose chunks never end
        pred_enc.encode(w, 256)
        for _ in range(9):
            w.write(5, 0x1F)
        return (4, 4, ep_cb, sel_cb, tables), (1, 1, w.getvalue())
    if case == "no_code":  # a 2-bit model with one symbol: the stream's 0b11 is no code
        tw = BitWriterLsb()
        write_huffman_table(tw, [2])
        for n in (4, 5, 64):
            write_huffman_table(tw, equal_length_sizes(n))
        tw.write(13, 0)
        return (4, 4, ep_cb, sel_cb, tw.getvalue()), (1, 1, b"\xff")
    flavour = {"global": (1, 0, 0), "hybrid": (0, 1, 0)}[case]
    w = BitWriterLsb()
    for bit in flavour:
        w.write(1, bit)
    return (4, 4, ep_cb, w.getvalue(), tables), None


ERROR_CASES = ["pred0", "pred1", "pred2", "empty_history", "endpoint_range", "vlc_overflow", "no_code", "global",
               "hybrid"]


@pytest.mark.parametrize("native", FRONTENDS, ids=["native", "plain"])
@pytest.mark.parametrize("case", ERROR_CASES)
def test_errors_match_jax_path_by_path(case, native):
    # the native path gives the C++ front-end's messages, the plain path the
    # reference's, each as the JAX package's same path does; both raise
    # Etc1sError, a BasisError (the JAX package's plain path raises its
    # HuffmanError, a ValueError, for a stream with no matching code)
    args, sl = _error_case(case)
    with pytest.raises(ValueError) as jexc:
        jdec = jf.Etc1sDecoder(*args, use_native=native)
        jdec.decode_slice(*sl[:2], sl[2])
    with pytest.raises(Etc1sError) as texc:
        dec = Etc1sDecoder(*args, native=native)
        dec.decode_slice(*sl[:2], sl[2])
    assert str(texc.value) == str(jexc.value)
    assert isinstance(texc.value, BasisError)


def test_native_and_plain_messages_differ_as_in_jax():
    _, sl = _error_case("pred0")
    args, _ = _error_case("pred0")
    messages = []
    for native in FRONTENDS:
        with pytest.raises(Etc1sError) as exc:
            Etc1sDecoder(*args, native=native).decode_slice(*sl[:2], sl[2])
        messages.append(str(exc.value))
    assert messages == ["predictor references out-of-bounds neighbor", "left predictor at column 0"]


@pytest.mark.parametrize("native", FRONTENDS, ids=["native", "plain"])
def test_unparsable_tables(native):
    # 21 code-length codes of 1 bit: the canonical codes overflow 16 bits.
    # The C++ front-end refuses the tables as a whole, the plain one names
    # the fault, as the JAX package's two paths do.
    tw = BitWriterLsb()
    tw.write(14, 3)
    tw.write(5, 21)
    for _ in range(21):
        tw.write(3, 1)
    args = (4, 4, *_error_case("pred0")[0][2:4], tw.getvalue())
    with pytest.raises(ValueError) as jexc:
        jf.Etc1sDecoder(*args, use_native=native)
    with pytest.raises(Etc1sError) as texc:
        Etc1sDecoder(*args, native=native)
    expect = "failed to parse ETC1S Huffman tables" if native else "Code lengths are invalid, codes don't fit into 16 bits"
    assert str(texc.value) == str(jexc.value) == expect


# ---------------------------------------------------------------------------
# Huffman tables and bit I/O (as tests/test_huffman.py)
# ---------------------------------------------------------------------------


def random_code_sizes(rng, n_syms: int) -> list[int]:
    """A Kraft-complete code-length assignment from a Huffman tree build."""
    freqs = rng.integers(1, 1000, n_syms)
    heap = [(int(f), [i]) for i, f in enumerate(freqs)]
    depth = [0] * n_syms
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, a = heapq.heappop(heap)
        fb, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, a + b))
    return [max(1, min(d, 16)) for d in depth] if n_syms > 1 else [1]


@pytest.mark.parametrize("n_syms", [1, 2, 7, 40, 300])
def test_huffman_table_round_trip(n_syms):
    rng = np.random.default_rng(n_syms)
    w = BitWriterLsb()
    enc = write_huffman_table(w, equal_length_sizes(n_syms))
    syms = rng.integers(0, n_syms, 200)
    for s in syms:
        enc.encode(w, int(s))
    data = w.getvalue()
    r = BitReaderLsb(data)
    table = read_huffman_table(r)
    assert [table.decode_symbol(r) for _ in range(200)] == syms.tolist()
    jtable = jh.read_huffman_table(jh.BitReaderLsb(data))
    np.testing.assert_array_equal(table.symbols, jtable.symbols)
    np.testing.assert_array_equal(table.code_sizes, jtable.code_sizes)


def test_random_tree_round_trip():
    rng = np.random.default_rng(7)
    for _ in range(5):
        n = int(rng.integers(2, 60))
        sizes = random_code_sizes(rng, n)
        table = HuffmanDecodingTable.from_sizes(sizes)
        enc = CanonicalEncoder(sizes)
        assert enc.codes == jw.CanonicalEncoder(sizes).codes
        w = BitWriterLsb()
        syms = rng.integers(0, n, 64)
        for s in syms:
            enc.encode(w, int(s))
        r = BitReaderLsb(w.getvalue())
        assert [table.decode_symbol(r) for _ in range(64)] == syms.tolist()


def test_decode_unassigned_code_errors():
    table = HuffmanDecodingTable.from_sizes([2])  # codes 01, 10, 11 unassigned
    with pytest.raises(HuffmanError, match="No matching code"):
        table.decode_symbol(BitReaderLsb(b"\xff"))


def test_bit_reader_past_end_zero_bits():
    r = BitReaderLsb(b"\xff")
    assert r.read(8) == 0xFF
    assert r.read(16) == 0  # past the end (bitreader.rs:45)


def test_bit_writer_round_trip():
    rng = np.random.default_rng(0)
    w, jwr = BitWriterLsb(), jw.BitWriterLsb()
    fields = []
    for _ in range(100):
        count = int(rng.integers(1, 25))
        v = int(rng.integers(0, 1 << count))
        fields.append((count, v))
        w.write(count, v)
        jwr.write(count, v)
    assert w.getvalue() == jwr.getvalue()
    r = BitReaderLsb(w.getvalue())
    assert [r.read(count) for count, _ in fields] == [v for _, v in fields]
