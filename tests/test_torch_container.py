"""PyTorch port: the UASTC .basis file path (basisu_rs_tpu_torch/container/)
against the JAX package's container: synthetic multi-slice UASTC files read
through both packages' read_to_{rgba,astc,bc7,etc1,etc2,uastc} on the CPU, bit-exact
(tolerance 0) on w, h, stride and data, the same error messages, the
writer's bytes, and the host C++ CRC against its Python version."""

import numpy as np
import pytest

import basisu_rs_tpu.container.basis as jb
import basisu_rs_tpu.container.writer as jw
import basisu_rs_tpu_torch as tb
import basisu_rs_tpu_torch.container.writer as tw
from basisu_rs_tpu.api import BasisError as JBasisError
from basisu_rs_tpu.tables import MODES
from basisu_rs_tpu_torch.container.crc import crc16, crc16_plain
from basisu_rs_tpu_torch.ops import kernels

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


@pytest.mark.parametrize("size", [0, 1, 2, 77, 1000, 65537])
def test_crc_native_matches_plain(size):
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    init = int(rng.integers(0, 1 << 16))
    assert crc16(data) == crc16_plain(data)
    assert crc16(data, init) == crc16_plain(data, init)
    assert crc16(memoryview(data)[size // 3 :]) == crc16_plain(data[size // 3 :])


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
    # an ETC1S file (no slices): read_to_rgba and read_to_etc1 name their
    # ROADMAP item; the other readers refuse the format with the JAX
    # package's message
    buf = tw._pack_header(data_size=0, data_crc16=crc16(b""), total_slices=0, total_images=0,
                          tex_format=0, flags=1, tex_type=0, slice_desc_ofs=77)
    for reader in ("read_to_rgba", "read_to_etc1"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
            getattr(tb, reader)(buf, device=CPU)
    for reader in ("read_to_astc", "read_to_bc7", "read_to_etc2", "read_to_uastc"):
        with pytest.raises(JBasisError) as jexc:
            getattr(jb, reader)(buf)
        with pytest.raises(tb.BasisError) as texc:
            getattr(tb, reader)(buf, device=CPU)
        assert str(texc.value) == str(jexc.value) == "unsupported texture format"
