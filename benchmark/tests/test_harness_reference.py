"""The reference and the frozen writers: golden outputs, the vectorised
ETC1S decoder against the oracle's state machine, the files against the
reference's own parser, CRC-16/GENIBUS against its plain loop."""

import binascii
import os

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import basis_file, etc1s, etc1s_oracle, uastc


def genibus(data: bytes) -> int:
    crc = 0xFFFF
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc ^ 0xFFFF


def test_crc_is_genibus():
    for data in (b"", b"123456789", os.urandom(997)):
        assert basis_file.crc16(data) == genibus(data)
    assert basis_file.crc16(b"123456789") == 0xD64E  # the catalogued check value
    assert basis_file.crc16(b"ab") == binascii.crc_hqx(b"ab", 0xFFFF) ^ 0xFFFF


def test_uastc_reference_is_golden():
    with np.load(inputs.GOLDEN) as d:
        blocks, want = d["bc7_in"], d["bc7_out"]
    out, err = uastc.block_table(blocks, "bc7")
    assert not err.any()
    assert np.array_equal(out, np.ascontiguousarray(want).view(np.uint8).reshape(len(blocks), -1))


def test_bc7_control_breaks_bytes():
    blocks = inputs.golden_blocks()
    out, _ = uastc.block_table(blocks, "bc7")
    ctl, _ = uastc.block_table(blocks, "bc7", control=True)
    assert (out != ctl).any(axis=1).sum() > 0


def test_bf16_rounding():
    assert uastc.bf16(np.float32(1.0)) == np.float32(1.0)
    assert uastc.bf16(np.float32(1 + 2**-9)) == np.float32(1.0)  # ties to even
    assert uastc.bf16(np.float32(1 + 3 * 2**-9)) == np.float32(1 + 2**-7)


def test_table_index_finds_every_block():
    rng = np.random.default_rng(1)
    known = inputs.golden_blocks()
    blocks = known[rng.integers(0, len(known), 5000)].copy()
    blocks[7] = rng.integers(0, 256, 16, dtype=np.uint8)  # one block outside the known set
    rows, index = uastc.table_index(blocks, known)
    assert np.array_equal(rows[index], blocks)


@pytest.mark.parametrize("side", [1, 5, 16, 36])
def test_uastc_file_parses(side):
    rng = np.random.default_rng(side)
    pool = inputs.golden_blocks()
    buf = inputs.uastc_file(rng, side, pool)
    header, descs = basis_file.parse(buf)
    assert header["tex_format"] == basis_file.FORMAT_UASTC
    assert [(d["orig_width"], d["nbx"]) for d in descs] == [(w, x) for w, _h, x, _y in inputs.mip_chain(side)]
    for d in descs:
        assert genibus(basis_file.payload(buf, d)) == d["crc"]
    assert genibus(buf[77:]) == header["data_crc"] and genibus(buf[8:77]) == header["header_crc"]
    images = uastc.file_images(buf, "bc7", pool)
    assert sum(im["data"].size for im in images) == 16 * sum(d["nbx"] * d["nby"] for d in descs)


def test_corrupt_file_is_refused():
    buf = bytearray(inputs.uastc_file(np.random.default_rng(2), 8, inputs.golden_blocks()))
    buf[-1] ^= 1
    with pytest.raises(basis_file.ReferenceError, match="data CRC16"):
        basis_file.parse(bytes(buf))


@pytest.mark.parametrize("side", [4, 13, 32])
def test_etc1s_decoder_matches_oracle(side):
    rng = np.random.default_rng(100 + side)
    buf = inputs.etc1s_file(rng, side, 2048, 2048)
    header, descs, dec = etc1s.decoder(buf)
    for d in descs:
        data = basis_file.payload(buf, d)
        assert genibus(data) == d["crc"]
        ep, sel = etc1s.decode_slice(dec, d["nbx"], d["nby"], data)
        assert list(zip(ep.tolist(), sel.tolist())) == [tuple(b) for b in dec.decode_blocks(d["nbx"], d["nby"], data)]
    images = etc1s.file_rgba_images(buf, "cpu")
    oracle = etc1s_oracle.oracle_read_to_rgba(buf)
    assert len(images) == len(oracle)
    for im, (w, h, pixels) in zip(images, oracle):
        assert (im["w"], im["h"]) == (w, h)
        assert np.array_equal(im["data"].numpy(), np.array(pixels, np.uint8).reshape(-1))


def test_etc1s_codebooks_round_trip():
    rng = np.random.default_rng(7)
    buf = inputs.etc1s_file(rng, 8, 300, 200)
    _h, _d, dec = etc1s.decoder(buf)
    endpoints, selectors = etc1s.codebooks(dec)
    want_ep, want_sel = inputs.etc1s_codebooks(np.random.default_rng(7), 300, 200)
    assert np.array_equal(endpoints, want_ep) and np.array_equal(selectors, want_sel)


def test_etc1s_control_breaks_texels():
    endpoints, _ = inputs.etc1s_codebooks(np.random.default_rng(3), 2048, 4)
    assert (etc1s.palette(endpoints) != etc1s.palette(endpoints, control=True)).any()


def test_etc1s_subset_is_enforced():
    buf = inputs.etc1s_file(np.random.default_rng(4), 8, 64, 64)
    _h, descs, dec = etc1s.decoder(buf)
    data = bytearray(basis_file.payload(buf, descs[0]))
    data[0] |= 1  # the first prediction symbol's one-bit code turned into no code
    with pytest.raises(basis_file.ReferenceError):
        etc1s.decode_slice(dec, descs[0]["nbx"], descs[0]["nby"], bytes(data))


def test_raster_layout():
    words = torch.arange(2 * 3 * 16, dtype=torch.int32).reshape(6, 16)
    img = etc1s.raster(words, 3, 2).view(torch.int32).reshape(8, 12)
    assert img[0, :4].tolist() == [0, 1, 2, 3] and img[1, :4].tolist() == [4, 5, 6, 7]
    assert img[0, 4].item() == 16 and img[4, 0].item() == 48
