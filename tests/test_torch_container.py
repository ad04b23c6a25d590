"""PyTorch port: the .basis file paths (basisu_rs_tpu_torch/container/)
against the JAX package's container: synthetic multi-slice UASTC and ETC1S
files read through both packages' read_to_{rgba,astc,bc7,etc1,etc2,uastc}
on the CPU, bit-exact (tolerance 0) on w, h, stride and data, ETC1S files
also against the reference-transcribed oracle (tests/oracle_etc1s.py), the
same error messages, the writers' bytes, and the host C++ CRC (the path it
picks, its table path and its fold path) against its Python version and
binascii, with the recorder's counts of the bytes each path read."""

import binascii

import numpy as np
import pytest
import torch

import basisu_rs_tpu.container.basis as jb
import basisu_rs_tpu.container.writer as jw
import basisu_rs_tpu_torch as tb
import basisu_rs_tpu_torch.container as tc
import basisu_rs_tpu_torch.container.writer as tw
from basisu_rs_tpu.api import BasisError as JBasisError
from basisu_rs_tpu.tables import MODES
from basisu_rs_tpu_torch.container import crc as crc_mod
from basisu_rs_tpu_torch.container.crc import crc16, crc16_plain
from basisu_rs_tpu_torch.ops import etc1s, kernels
from basisu_rs_tpu_torch.utils import profiling
from oracle_etc1s import oracle_make_decoder, oracle_read_to_etc1, oracle_read_to_rgba
from torch_cases import etc1s_codebooks

CPU = "cpu"
READERS = ["read_to_rgba", "read_to_astc", "read_to_bc7", "read_to_etc1", "read_to_etc2", "read_to_uastc"]


def _slices(golden, seed=0):
    """Three slices of the golden blocks (every mode), shuffled, of odd
    sizes: 8x4, 3x5 and 1x1 blocks."""
    rng = np.random.default_rng(seed)
    blocks = golden["bc7_in"][rng.permutation(len(golden["bc7_in"]))]
    dims = [(8, 4, 32, 13), (3, 5, 11, 20), (1, 1, 3, 2)]
    out, ofs = [], 0
    for nbx, nby, w, h in dims:
        n = nbx * nby
        out.append(dict(blocks=blocks[ofs : ofs + n], nbx=nbx, nby=nby, orig_width=w, orig_height=h))
        ofs += n
    return out


def _images(result):
    return result[1] if isinstance(result, tuple) else result


def _assert_images_equal(t_images, j_images):
    assert len(t_images) == len(j_images)
    for t, j in zip(t_images, j_images):
        assert (t.w, t.h, t.stride) == (j.w, j.h, j.stride)
        assert t.data.device.type == "cpu"
        data = t.data.numpy()
        assert data.dtype == j.data.dtype and data.shape == j.data.shape
        np.testing.assert_array_equal(data, j.data)


@pytest.mark.parametrize("reader", READERS)
def test_read_matches_jax(golden, reader):
    buf = tw.write_uastc_basis(_slices(golden))
    _assert_images_equal(_images(getattr(tb, reader)(buf, device=CPU)), _images(getattr(jb, reader)(buf)))


def test_read_to_rgba_header_matches_jax(golden):
    buf = tw.write_uastc_basis(_slices(golden, seed=1))
    header, _ = tb.read_to_rgba(buf, device=CPU)
    j_header, _ = jb.read_to_rgba(buf)
    for field in ("sig", "ver", "header_size", "header_crc16", "data_size", "data_crc16",
                  "total_slices", "total_images", "tex_format", "flags", "tex_type", "slice_desc_file_ofs"):
        assert getattr(header, field) == getattr(j_header, field), field


def test_one_transcode_per_file(golden):
    # every slice of the file goes through one partition: each present mode
    # is one plain-version call for the whole file
    buf = tw.write_uastc_basis(_slices(golden))
    kernels.reset_counts()
    tb.read_to_bc7(buf, device=CPU)
    assert max(kernels.plain_call_counts()["bc7"]) == 1


def test_empty_file_matches_jax():
    buf = tw.write_uastc_basis([])
    for reader in READERS:
        assert _images(getattr(tb, reader)(buf, device=CPU)) == _images(getattr(jb, reader)(buf)) == []


def test_writer_matches_jax_byte_for_byte(golden):
    slices = _slices(golden, seed=2)
    slices[1]["image_index"] = 7
    slices[2]["level_index"] = 3
    assert tw.write_uastc_basis(slices) == jw.write_uastc_basis(slices)


CRC_SIZES = [0, 1, 2, 15, 16, 17, 63, 64, 65, 77, 127, 128, 129, 255, 1000, 4103, 65537, (1 << 20) + 13]
# each size through crc16, the path it picks (under the size alone as id, as
# before the two paths), then the table path alone and the fold path alone
CRC_CASES = [pytest.param(size, path, id=str(size) if path == "auto" else f"{size}-{path}")
             for path in ("auto", "table", "fold") for size in CRC_SIZES]


def _crc_oracle(data, init):
    """crc16_plain, or for long buffers binascii's CRC-16/XMODEM: GENIBUS
    is the same register with its input and output inverted."""
    if len(data) <= 4103:
        return crc16_plain(data, init)
    return 0xFFFF ^ binascii.crc_hqx(data, 0xFFFF ^ init)


def test_crc_oracles_agree():
    data = np.random.default_rng(5).integers(0, 256, 4103, dtype=np.uint8).tobytes()
    for init in (0, 0x1234, 0xFFFF):
        assert crc16_plain(data, init) == 0xFFFF ^ binascii.crc_hqx(data, 0xFFFF ^ init)


@pytest.mark.parametrize("size, path", CRC_CASES)
def test_crc_native_matches_plain(size, path):
    if path == "fold" and not crc_mod.has_fold():
        pytest.skip("this CPU has no PCLMULQDQ: the fold path does not run here")
    rng = np.random.default_rng(size)
    buf = rng.integers(0, 256, size + 16, dtype=np.uint8).tobytes()
    # start offsets 0-15 (unaligned loads), zero and random initial values
    for offset in range(16):
        data = memoryview(buf)[offset : offset + size]
        for init in (0, int(rng.integers(1, 1 << 16))):
            want = _crc_oracle(data, init)
            if path == "auto":
                assert crc16(data, init) == want
            elif path == "table":
                assert crc_mod.crc16_table(data, init) == want
            else:
                got, folded = crc_mod.crc16_fold(data, init)
                assert got == want and folded == (size // 16 * 16 if size >= 16 else 0)
    data = buf[:size]
    assert crc16(data) == _crc_oracle(data, 0)
    assert crc16(memoryview(data)[size // 3 :]) == _crc_oracle(data[size // 3 :], 0)
    assert crc16(np.frombuffer(data, np.uint8)) == _crc_oracle(data, 0)


def _crc_file(golden, fmt):
    if fmt == "uastc":
        return tw.write_uastc_basis(_slices(golden, seed=8))
    return _etc1s_file(False, seed=8)[3]


@pytest.mark.parametrize("fmt", ["uastc", "etc1s"])
@pytest.mark.parametrize("where", ["header", "first", "middle", "last"])
def test_crc_catches_a_flipped_bit(golden, fmt, where):
    buf = bytearray(_crc_file(golden, fmt))
    assert len(buf) - tc.Header.FILE_SIZE >= 128  # the data CRC takes the fold where the CPU has it
    at = {"header": 40, "first": tc.Header.FILE_SIZE, "middle": (tc.Header.FILE_SIZE + len(buf)) // 2,
          "last": len(buf) - 1}[where]
    buf[at] ^= 0x10
    message = "^Header CRC16 failed$" if where == "header" else "^Data CRC16 failed$"
    with pytest.raises(tb.BasisError, match=message):
        (tb.read_to_bc7 if fmt == "uastc" else tb.read_to_rgba)(bytes(buf), device=CPU)


@pytest.mark.parametrize("fmt", ["uastc", "etc1s"])
def test_crc_counters_count_one_read(golden, fmt):
    buf = _crc_file(golden, fmt)
    data = len(buf) - tc.Header.FILE_SIZE
    profiling.clear()
    profiling.enable()
    try:
        (tb.read_to_bc7 if fmt == "uastc" else tb.read_to_rgba)(buf, device=CPU)
        rec = profiling.records()
    finally:
        profiling.disable()
        profiling.clear()
    # the header's 69 bytes by the table, the data by the fold but its last data % 16 bytes
    assert rec.total("crc_bytes") == tc.Header.FILE_SIZE - 8 + data
    assert rec.total("crc_fold_bytes") == (data // 16 * 16 if crc_mod.has_fold() else 0)


def _corrupt(golden, case):
    """A file with one fault, each caught by its own check of the reader."""
    slices = _slices(golden, seed=3)
    if case == "sig":
        return b"\x00\x00" + tw.write_uastc_basis(slices)[2:]
    if case == "short_header":
        return tw.write_uastc_basis(slices)[:40]
    if case == "header_crc":
        buf = bytearray(tw.write_uastc_basis(slices))
        buf[30] ^= 1  # a header byte inside the CRC's range
        return bytes(buf)
    if case == "data_crc":
        buf = bytearray(tw.write_uastc_basis(slices))
        buf[-5] ^= 0x40
        return bytes(buf)
    if case == "not_whole_blocks":
        slices[2]["blocks"] = np.zeros((1, 15), np.uint8)  # 15-byte payload
        return tw.write_uastc_basis(slices)
    blocks = slices[1]["blocks"].copy()
    if case == "invalid_mode":
        blocks[4, 0] = 69
    else:  # invalid_pattern: a mode-2 block whose 5-bit pattern is 31 (>= 30)
        blocks[4] = 0
        blocks[4, 0] = 0x1D
        ofs = MODES[2].field_offsets["pattern"]
        for b in range(5):
            blocks[4, (ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    slices[1]["blocks"] = blocks
    return tw.write_uastc_basis(slices)


CASES = ["sig", "short_header", "header_crc", "data_crc", "not_whole_blocks", "invalid_mode", "invalid_pattern"]


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("case", CASES)
def test_errors_match_jax(golden, case, reader):
    buf = _corrupt(golden, case)
    if reader == "read_to_uastc" and case in ("not_whole_blocks", "invalid_mode", "invalid_pattern"):
        # the passthrough reads no block: both return the raw payload
        _assert_images_equal(tb.read_to_uastc(buf, device=CPU), jb.read_to_uastc(buf))
        return
    with pytest.raises(JBasisError) as jexc:
        getattr(jb, reader)(buf)
    with pytest.raises(tb.BasisError) as texc:
        getattr(tb, reader)(buf, device=CPU)
    assert str(texc.value) == str(jexc.value)


def test_first_failing_block_wins(golden):
    # an invalid pattern in slice 0 comes before an invalid mode in slice 1
    # and a payload of 15 bytes in slice 2: the reference aborts at the first
    slices = _slices(golden, seed=4)
    b0 = slices[0]["blocks"].copy()
    b0[-1] = 0
    b0[-1, 0] = 0x1D
    ofs = MODES[2].field_offsets["pattern"]
    for b in range(5):
        b0[-1, (ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    b1 = slices[1]["blocks"].copy()
    b1[0, 0] = 69
    slices[0]["blocks"], slices[1]["blocks"] = b0, b1
    slices[2]["blocks"] = np.zeros((1, 15), np.uint8)
    buf = tw.write_uastc_basis(slices)
    for reader in ("read_to_rgba", "read_to_astc", "read_to_bc7", "read_to_etc1", "read_to_etc2"):
        with pytest.raises(JBasisError, match="block pattern is not valid"):
            getattr(jb, reader)(buf)
        with pytest.raises(tb.BasisError, match="block pattern is not valid"):
            getattr(tb, reader)(buf, device=CPU)


@pytest.mark.parametrize("reader", ["read_to_etc1", "read_to_etc2"])
def test_etc_images_are_whole_blocks(golden, reader):
    # one image per slice of 8-byte (ETC1) or 16-byte (ETC2) blocks, a row
    # of blocks per stride, equal to the batch transcode of its blocks
    slices = _slices(golden)
    images = getattr(tb, reader)(tw.write_uastc_basis(slices), device=CPU)
    size = 8 if reader == "read_to_etc1" else 16
    for img, sl in zip(images, slices):
        assert img.stride == size * sl["nbx"]
        assert img.data.numel() == size * sl["nbx"] * sl["nby"]
        out, _ = tb.transcode_uastc_blocks(sl["blocks"], reader[-4:], device=CPU)
        np.testing.assert_array_equal(img.data.numpy(), out.numpy().reshape(-1))


def test_etc1s_files(golden):
    # an ETC1S file with no slices: read_to_rgba and read_to_etc1 return no
    # image, as the JAX package's readers do; the other readers refuse the
    # format with the JAX package's message
    buf = tw._pack_header(data_size=0, data_crc16=crc16(b""), total_slices=0, total_images=0,
                          tex_format=0, flags=1, tex_type=0, slice_desc_ofs=77)
    header, images = tb.read_to_rgba(buf, device=CPU)
    assert images == jb.read_to_rgba(buf)[1] == [] and header.total_slices == 0
    assert tb.read_to_etc1(buf, device=CPU) == jb.read_to_etc1(buf) == []
    for reader in ("read_to_astc", "read_to_bc7", "read_to_etc2", "read_to_uastc"):
        with pytest.raises(JBasisError) as jexc:
            getattr(jb, reader)(buf)
        with pytest.raises(tb.BasisError) as texc:
            getattr(tb, reader)(buf, device=CPU)
        assert str(texc.value) == str(jexc.value) == "unsupported texture format"


# ---------------------------------------------------------------------------
# ETC1S files
# ---------------------------------------------------------------------------


def _etc1s_file(alpha, seed=0, dims=((6, 4, 23, 14), (3, 5, 12, 20), (1, 1, 3, 2)), e=40, s=30):
    """(endpoints, selectors, slices, file): one slice per image, or an
    (RGB, alpha) pair per image when alpha; widths not multiples of 4."""
    rng = np.random.default_rng(seed)
    endpoints, selectors = etc1s_codebooks(rng, e, s)
    slices = []
    for nbx, nby, w, h in dims:
        for is_alpha in ((False, True) if alpha else (False,)):
            n = nbx * nby
            slices.append(dict(ep_idx=rng.integers(0, e, n), sel_idx=rng.integers(0, s, n), nbx=nbx, nby=nby,
                               orig_width=w, orig_height=h, alpha=is_alpha))
    return endpoints, selectors, slices, tw.write_etc1s_basis(endpoints, selectors, slices, has_alpha=alpha)


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "alpha"])
def test_etc1s_writer_matches_jax_byte_for_byte(alpha):
    endpoints, selectors, slices, buf = _etc1s_file(alpha, seed=1)
    assert buf == jw.write_etc1s_basis(endpoints, selectors, slices, has_alpha=alpha)


@pytest.mark.parametrize("e,s", [(1, 1), (2, 3), (255, 256), (2048, 300)])
def test_etc1s_writer_code_widths_match_jax(e, s):
    # the numpy payload packer against the JAX writer's symbol-at-a-time
    # one, across code widths of 1 to 11 bits and an odd row length
    endpoints, selectors, slices, buf = _etc1s_file(False, seed=e, dims=((7, 3, 28, 12),), e=e, s=s)
    assert buf == jw.write_etc1s_basis(endpoints, selectors, slices)


@pytest.mark.parametrize("seed,hist,video", [(0, 0, False), (1, 16, False), (3, 8, True)])
def test_etc1s_fuzz_writer_matches_jax(seed, hist, video):
    rng = np.random.default_rng(seed)
    endpoints, selectors = etc1s_codebooks(rng, 50, 40)
    got = tw.write_etc1s_basis_fuzz(endpoints, selectors, 9, 7, hist, seed=seed, is_video=video)
    expect = jw.write_etc1s_basis_fuzz(endpoints, selectors, 9, 7, hist, seed=seed, is_video=video)
    assert got[0] == expect[0]
    np.testing.assert_array_equal(got[1], expect[1])
    np.testing.assert_array_equal(got[2], expect[2])


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "alpha"])
@pytest.mark.parametrize("reader", ["read_to_rgba", "read_to_etc1"])
def test_etc1s_read_matches_jax_and_oracle(reader, alpha):
    *_, buf = _etc1s_file(alpha, seed=2)
    got, expect = _images(getattr(tb, reader)(buf, device=CPU)), _images(getattr(jb, reader)(buf))
    _assert_images_equal(got, expect)
    oracle = (oracle_read_to_rgba if reader == "read_to_rgba" else oracle_read_to_etc1)(buf)
    assert len(got) == len(oracle)
    for img, (w, h, data) in zip(got, oracle):
        assert (img.w, img.h) == (w, h)
        np.testing.assert_array_equal(img.data.numpy(), np.asarray(bytearray(data) if reader == "read_to_etc1"
                                                                   else data, np.uint8).reshape(-1))


@pytest.mark.parametrize("seed,hist,video", [(0, 0, False), (1, 16, False), (2, 64, False), (3, 8, True)])
def test_etc1s_fuzz_files_match_oracle(seed, hist, video):
    rng = np.random.default_rng(300 + seed)
    endpoints, selectors = etc1s_codebooks(rng, int(rng.integers(2, 100)), int(rng.integers(2, 80)))
    nbx, nby = int(rng.integers(1, 12)), int(rng.integers(1, 10))
    buf, _, _ = tw.write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video)
    (w, h, pixels), = oracle_read_to_rgba(buf)
    (img,) = tb.read_to_rgba(buf, device=CPU)[1]
    assert (img.w, img.h, img.stride) == (w, h, 16 * nbx)
    np.testing.assert_array_equal(img.data.numpy(), np.asarray(pixels, np.uint8).reshape(-1))
    (_, _, blocks), = oracle_read_to_etc1(buf)
    (e1,) = tb.read_to_etc1(buf, device=CPU)
    np.testing.assert_array_equal(e1.data.numpy(), np.frombuffer(blocks, np.uint8))


def test_etc1s_mip_chain_one_call_per_file():
    # 10 mip levels share the file's codebooks: each reader makes one call
    # of the plain version (one kernel launch on the card) for the file
    rng = np.random.default_rng(11)
    endpoints, selectors = etc1s_codebooks(rng, 60, 50)
    slices = []
    for lvl in range(10):  # 130x3 blocks down to 1x1: odd tails
        w, h = max(1, 130 >> lvl), max(1, 3 >> lvl)
        slices.append(dict(ep_idx=rng.integers(0, 60, w * h), sel_idx=rng.integers(0, 50, w * h), nbx=w, nby=h,
                           orig_width=4 * w, orig_height=4 * h))
    buf = tw.write_etc1s_basis(endpoints, selectors, slices)
    etc1s.reset_counts()
    _, images = tb.read_to_rgba(buf, device=CPU)
    etc1_images = tb.read_to_etc1(buf, device=CPU)
    assert etc1s.plain_call_counts() == {"rgba": 1, "alpha": 0, "rgba_alpha": 0, "etc1": 1}
    _assert_images_equal(images, jb.read_to_rgba(buf)[1])
    _assert_images_equal(etc1_images, jb.read_to_etc1(buf))
    for img, sl in zip(etc1_images, slices):
        one = etc1s.run_etc1s_etc1(endpoints, selectors, sl["ep_idx"], sl["sel_idx"], device=CPU)
        np.testing.assert_array_equal(img.data.numpy(), one.view(torch.uint8).numpy().reshape(-1))


def test_etc1s_alpha_file_is_one_fused_call():
    *_, buf = _etc1s_file(True, seed=3)
    etc1s.reset_counts()
    tb.read_to_rgba(buf, device=CPU)
    assert etc1s.plain_call_counts() == {"rgba": 0, "alpha": 0, "rgba_alpha": 1, "etc1": 0}


def test_etc1s_stride_and_unsupported_targets():
    # COMPAT.md item 2: RGBA rows are 4 * num_blocks_x texels apart whatever
    # the width; item 3: ETC1S to ETC2, ASTC, BC7 or UASTC raises
    _, _, slices, buf = _etc1s_file(False, seed=4)
    _, images = tb.read_to_rgba(buf, device=CPU)
    for img, sl in zip(images, slices):
        assert img.stride == 16 * sl["nbx"] and img.data.numel() == 64 * sl["nbx"] * sl["nby"]
    for img, sl in zip(tb.read_to_etc1(buf, device=CPU), slices):
        assert img.stride == 8 * sl["nbx"]
    for reader in ("read_to_astc", "read_to_bc7", "read_to_etc2", "read_to_uastc"):
        with pytest.raises(tb.BasisError, match="^unsupported texture format$"):
            getattr(tb, reader)(buf, device=CPU)


def _etc1s_fault(case):
    endpoints, selectors, slices, _ = _etc1s_file(True, seed=5)
    if case == "odd_slices":
        return tw.write_etc1s_basis(endpoints, selectors, slices[:-1], has_alpha=True)
    if case == "missing_alpha_flag":
        slices[3]["alpha"] = False
    else:  # dimension mismatch: the second pair's alpha slice is one block row short
        sl = slices[3]
        n = sl["nbx"] * (sl["nby"] - 1)
        slices[3] = dict(sl, nby=sl["nby"] - 1, ep_idx=sl["ep_idx"][:n], sel_idx=sl["sel_idx"][:n])
    return tw.write_etc1s_basis(endpoints, selectors, slices, has_alpha=True)


@pytest.mark.parametrize("reader", ["read_to_rgba", "read_to_etc1"])
@pytest.mark.parametrize("case", ["odd_slices", "missing_alpha_flag", "dimension_mismatch"])
def test_etc1s_errors_match_jax(case, reader):
    buf = _etc1s_fault(case)
    if reader == "read_to_etc1" and case != "odd_slices":
        # read_to_etc1 decodes every slice on its own: no pairing to check
        _assert_images_equal(tb.read_to_etc1(buf, device=CPU), jb.read_to_etc1(buf))
        return
    with pytest.raises(JBasisError) as jexc:
        getattr(jb, reader)(buf)
    with pytest.raises(tb.BasisError) as texc:
        getattr(tb, reader)(buf, device=CPU)
    assert str(texc.value) == str(jexc.value)


def test_etc1s_corrupt_crc_matches_jax():
    buf = bytearray(_etc1s_file(False, seed=6)[3])
    buf[-3] ^= 0x20
    for reader in ("read_to_rgba", "read_to_etc1"):
        with pytest.raises(tb.BasisError, match="^Data CRC16 failed$"):
            getattr(tb, reader)(bytes(buf), device=CPU)


def test_etc1s_header_and_slice_flags_match_jax():
    *_, buf = _etc1s_file(True, seed=7)
    header, j_header = tc.read_header(buf), jb.read_header(buf)
    assert header == tb.Header(**vars(j_header))
    assert (header.has_alpha, header.has_y_flipped) == (j_header.has_alpha, j_header.has_y_flipped) == (True, False)
    descs, j_descs = tc.read_slice_descs(buf, header), jb.read_slice_descs(buf, j_header)
    assert [d.has_alpha for d in descs] == [d.has_alpha for d in j_descs] == [False, True] * 3
    assert all(bytes(d.data(buf)) == j.data(buf) for d, j in zip(descs, j_descs))


def test_etc1s_endpoint_count_quirk():
    # COMPAT.md item 1: the reference passes total_selectors as the endpoint
    # count; by default the port, like the JAX package, uses total_endpoints
    rng = np.random.default_rng(11)
    endpoints, selectors = etc1s_codebooks(rng, 50, 20)  # E != S on purpose
    buf = tw.write_etc1s_basis(endpoints, selectors, [dict(ep_idx=rng.integers(0, 50, 32), sel_idx=rng.integers(0, 20, 32),
                                                           nbx=8, nby=4, orig_width=32, orig_height=16)])
    h = tc.read_header(buf)
    assert len(tc.make_etc1s_decoder(h, buf).endpoints) == 50
    for native in (True, False):
        quirk = tc.make_etc1s_decoder(h, buf, endpoint_count_quirk=True, native=native)
        j_quirk = jb.make_etc1s_decoder(jb.read_header(buf), buf, endpoint_count_quirk=True)
        np.testing.assert_array_equal(quirk.endpoints, j_quirk.endpoints)
        q = np.array([[*c5, i5] for c5, i5 in oracle_make_decoder(buf, quirk_endpoint_count=True).endpoints], np.uint8)
        np.testing.assert_array_equal(quirk.endpoints, q)
        assert len(quirk.endpoints) == 20
