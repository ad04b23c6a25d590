"""PyTorch port: the KTX, KTX2 and PNG writers (basisu_rs_tpu_torch/
container/{ktx,ktx2,png}.py) against the JAX package's.

The same .basis files go through both packages' readers (the port's with
device="cpu") and both packages' writers; the blobs must be byte-equal
(tolerance 0), round-trip through the independent test readers
tests/ktx1_reader.py and tests/ktx2_reader.py, and the refusals must raise
the same messages."""

import numpy as np
import pytest

import basisu_rs_tpu as jpkg
import basisu_rs_tpu.container.ktx as jktx
import basisu_rs_tpu.container.ktx2 as jktx2
import basisu_rs_tpu.container.png as jpng
import basisu_rs_tpu_torch as tpkg
from basisu_rs_tpu.container.writer import write_etc1s_basis
from basisu_rs_tpu_torch.container import basis, ktx, ktx2, png
from tests.ktx1_reader import read_ktx1
from tests.ktx2_reader import read_ktx2
from tests.test_ktx import _basis_with_mips

TARGETS = ("bc7", "astc", "etc1", "etc2", "rgba")


def _images(pkg, target, buf, **kw):
    res = getattr(pkg, f"read_to_{target}")(buf, **kw)
    return res[1] if target == "rgba" else res


def _etc1s_alpha_file():
    rng = np.random.default_rng(3)
    endpoints = np.zeros((8, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (8, 3))
    endpoints[:, 3] = rng.integers(0, 8, 8)
    selectors = rng.integers(0, 256, (8, 4)).astype(np.uint8)
    sl = dict(nbx=2, nby=2, orig_width=7, orig_height=6)
    return write_etc1s_basis(endpoints, selectors, [
        dict(ep_idx=rng.integers(0, 8, 4), sel_idx=rng.integers(0, 8, 4), alpha=alpha, **sl) for alpha in (False, True)
    ], has_alpha=True)


@pytest.mark.parametrize("target", TARGETS)
def test_ktx_and_ktx2_bytes_equal_jax(target):
    buf = _basis_with_mips()
    mine, ref = _images(tpkg, target, buf, device="cpu"), _images(jpkg, target, buf)
    descs = basis.read_slice_descs(buf, basis.read_header(buf))
    chains = ktx.group_mip_chains(mine, descs)
    j_chains = jktx.group_mip_chains(ref, descs)
    assert [len(c) for c in chains] == [len(c) for c in j_chains] == [2, 1]
    for chain, j_chain in zip(chains, j_chains):
        blob1, blob2 = ktx.write_ktx(chain, target), ktx2.write_ktx2(chain, target)
        assert blob1 == jktx.write_ktx(j_chain, target)
        assert blob2 == jktx2.write_ktx2(j_chain, target)
        p1, p2 = read_ktx1(blob1), read_ktx2(blob2)
        assert (p1.width, p1.height, len(p1.levels)) == (chain[0].w, chain[0].h, len(chain))
        assert len(p2.levels) == len(chain)
        for lvl, img in enumerate(chain):
            data = img.data.numpy()
            if target == "rgba":
                expect = b"".join(data[y * img.stride: y * img.stride + 4 * img.w].tobytes() for y in range(img.h))
            else:
                expect = data.tobytes()
            assert p1.levels[lvl] == expect and p2.levels[lvl] == expect


@pytest.mark.parametrize("target", ("rgba", "etc1"))
def test_etc1s_alpha_file_writers_equal_jax(target):
    buf = _etc1s_alpha_file()
    mine, ref = _images(tpkg, target, buf, device="cpu"), _images(jpkg, target, buf)
    assert len(mine) == len(ref)
    for img, j_img in zip(mine, ref):
        assert ktx.write_ktx([img], target) == jktx.write_ktx([j_img], target)
        assert ktx2.write_ktx2([img], target) == jktx2.write_ktx2([j_img], target)
        if target == "rgba":
            assert png.write_png(img) == jpng.write_png(j_img)


def test_png_bytes_equal_jax():
    buf = _basis_with_mips()
    mine, ref = _images(tpkg, "rgba", buf, device="cpu"), _images(jpkg, "rgba", buf)
    for img, j_img in zip(mine, ref):  # the 3x3 image crops its block-padded rows
        assert png.write_png(img) == jpng.write_png(j_img)


@pytest.mark.parametrize("writer", ["ktx", "ktx2"])
def test_writer_refusals_match_jax(writer):
    buf = _basis_with_mips()
    mine, ref = _images(tpkg, "bc7", buf, device="cpu"), _images(jpkg, "bc7", buf)
    fn = {"ktx": ktx.write_ktx, "ktx2": ktx2.write_ktx2}[writer]
    j_fn = {"ktx": jktx.write_ktx, "ktx2": jktx2.write_ktx2}[writer]
    uastc, j_uastc = tpkg.read_to_uastc(buf, device="cpu"), jpkg.read_to_uastc(buf)
    cases = (
        (lambda f, imgs, u: f([u[0]], "uastc")),  # no format mapping
        (lambda f, imgs, u: f([], "bc7")),  # no images
        (lambda f, imgs, u: f([imgs[0], imgs[2]], "bc7")),  # 8x8 then 3x3: not a halving chain
    )
    for case in cases:
        with pytest.raises(ValueError) as e:
            case(fn, mine, uastc)
        with pytest.raises(ValueError) as je:
            case(j_fn, ref, j_uastc)
        assert str(e.value) == str(je.value)
