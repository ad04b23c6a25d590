"""PyTorch port: the public API (basisu_rs_tpu_torch/api.py) against the
JAX package's api.py, bit-exact, with the same block-level errors.  Every
call here asks for device="cpu" (the plain versions); the port's default
device is the card."""

import numpy as np
import pytest
import torch

import basisu_rs_tpu.api as japi
import basisu_rs_tpu_torch as tapi
from basisu_rs_tpu.container.writer import write_etc1s_basis, write_uastc_basis
from basisu_rs_tpu.tables import MODES
from basisu_rs_tpu_torch.ops import etc1s, kernels

CPU = "cpu"


def _mixed_blocks(golden):
    """Golden blocks, random blocks with every 7-bit code (invalid mode 19
    and out-of-range patterns included), and zero blocks, shuffled."""
    rng = np.random.default_rng(5)
    r = rng.integers(0, 256, (1024, 16), dtype=np.uint8)
    blocks = np.concatenate([golden["bc7_in"], r, np.zeros((3, 16), np.uint8)])
    return np.ascontiguousarray(blocks[rng.permutation(len(blocks))])


def _bad_pattern_block():
    block = np.zeros(16, np.uint8)
    block[0] = 0x1D  # a mode-2 code; pattern field set to 31 (>= 30)
    ofs = MODES[2].field_offsets["pattern"]
    for b in range(5):
        block[(ofs + b) // 8] |= 1 << ((ofs + b) % 8)
    return block


def test_batch_matches_jax(golden):
    blocks = _mixed_blocks(golden)
    e_out, e_err = japi.transcode_uastc_blocks(blocks, "bc7")
    out, err = tapi.transcode_uastc_blocks(blocks, "bc7", device=CPU)
    assert out.dtype == torch.uint8 and out.shape == (len(blocks), 16)
    assert err.dtype == torch.bool and err.shape == (len(blocks),)
    assert err.numpy().any() and not err.numpy().all()
    np.testing.assert_array_equal(err.numpy(), e_err)
    np.testing.assert_array_equal(out.numpy(), e_out)


@pytest.mark.parametrize("target", ["astc", "rgba"])
def test_batch_astc_rgba_match_jax(golden, target):
    blocks = _mixed_blocks(golden)
    e_out, e_err = japi.transcode_uastc_blocks(blocks, target)
    out, err = tapi.transcode_uastc_blocks(blocks, target, device=CPU)
    assert out.dtype == (torch.uint32 if target == "rgba" else torch.uint8)
    assert tuple(out.shape) == e_out.shape
    assert err.numpy().any() and not err.numpy().all()
    np.testing.assert_array_equal(err.numpy(), e_err)
    np.testing.assert_array_equal(out.numpy(), e_out)


@pytest.mark.parametrize("target", ["etc1", "etc2"])
def test_batch_etc_match_jax(golden, target):
    blocks = _mixed_blocks(golden)
    e_out, e_err = japi.transcode_uastc_blocks(blocks, target)
    out, err = tapi.transcode_uastc_blocks(blocks, target, device=CPU)
    assert out.dtype == torch.uint8 and tuple(out.shape) == e_out.shape == (len(blocks), 8 if target == "etc1" else 16)
    assert err.numpy().any() and not err.numpy().all()
    np.testing.assert_array_equal(err.numpy(), e_err)
    np.testing.assert_array_equal(out.numpy(), e_out)


def test_batch_takes_torch_and_device(golden):
    t = torch.from_numpy(golden["bc7_in"][:40].copy())
    out, err = tapi.transcode_uastc_blocks(t, "bc7", device=CPU)
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), golden["bc7_out"][:40])
    assert not err.any()


def test_empty_batch():
    out, err = tapi.transcode_uastc_blocks(np.zeros((0, 16), np.uint8), "bc7", device=CPU)
    e_out, e_err = japi.transcode_uastc_blocks(np.zeros((0, 16), np.uint8), "bc7")
    assert tuple(out.shape) == e_out.shape == (0, 16)
    assert tuple(err.shape) == e_err.shape == (0,)


@pytest.mark.parametrize("index", [0, 100, 303, 607])
def test_single_block_matches_jax(golden, index):
    block = golden["bc7_in"][index]
    got = tapi.transcode_uastc_block_to_bc7(block, device=CPU)
    assert got == japi.transcode_uastc_block_to_bc7(block) == golden["bc7_out"][index].tobytes()
    assert tapi.transcode_uastc_block_to_bc7(bytes(block), device=CPU) == got


@pytest.mark.parametrize("index", [0, 100, 303, 607])
def test_single_block_astc_rgba_match_jax(golden, index):
    block = golden["astc_in"][index]
    astc = tapi.transcode_uastc_block_to_astc(block, device=CPU)
    assert astc == japi.transcode_uastc_block_to_astc(block) == golden["astc_out"][index].tobytes()
    rgba = tapi.unpack_uastc_block_to_rgba(bytes(golden["rgba_in"][index]), device=CPU)
    e_rgba = japi.unpack_uastc_block_to_rgba(golden["rgba_in"][index])
    assert rgba.dtype == e_rgba.dtype == np.uint32
    np.testing.assert_array_equal(rgba, e_rgba)
    np.testing.assert_array_equal(rgba, golden["rgba_out"][index])


@pytest.mark.parametrize("target", ["etc1", "etc2"])
@pytest.mark.parametrize("index", [0, 100, 303, 607])
def test_single_block_etc_match_jax(golden, target, index):
    block = golden[f"{target}_in"][index]
    fn = f"transcode_uastc_block_to_{target}"
    got = getattr(tapi, fn)(block, device=CPU)
    assert got == getattr(japi, fn)(block) == golden[f"{target}_out"][index].tobytes()
    assert getattr(tapi, fn)(bytes(block), device=CPU) == got


def _error_block(case):
    if case == "invalid_mode":
        block = np.zeros(16, np.uint8)
        block[0] = 69
        return block
    if case == "invalid_pattern":
        return _bad_pattern_block()
    return np.zeros(15, np.uint8)


def _assert_same_error(fn, block):
    with pytest.raises(japi.BasisError) as jexc:
        getattr(japi, fn)(block)
    with pytest.raises(tapi.BasisError) as texc:
        getattr(tapi, fn)(block, device=CPU)
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("case", ["invalid_mode", "invalid_pattern", "short"])
def test_single_block_errors_match_jax(case):
    _assert_same_error("transcode_uastc_block_to_bc7", _error_block(case))


@pytest.mark.parametrize("fn", ["transcode_uastc_block_to_astc", "unpack_uastc_block_to_rgba"])
@pytest.mark.parametrize("case", ["invalid_mode", "invalid_pattern", "short"])
def test_single_block_astc_rgba_errors_match_jax(case, fn):
    _assert_same_error(fn, _error_block(case))


@pytest.mark.parametrize("fn", ["transcode_uastc_block_to_etc1", "transcode_uastc_block_to_etc2"])
@pytest.mark.parametrize("case", ["invalid_mode", "invalid_pattern", "short"])
def test_single_block_etc_errors_match_jax(case, fn):
    _assert_same_error(fn, _error_block(case))


def test_into_rgba_bytes_matches_jax(golden):
    out, _ = tapi.transcode_uastc_blocks(golden["rgba_in"][:4], "rgba", device=CPU)
    e_out, _ = japi.transcode_uastc_blocks(golden["rgba_in"][:4], "rgba")
    img = tapi.Image(w=16, h=4, stride=16, data=out.reshape(-1)).into_rgba_bytes()
    e_img = japi.Image(w=16, h=4, stride=16, data=e_out.reshape(-1)).into_rgba_bytes()
    assert (img.w, img.h, img.stride) == (e_img.w, e_img.h, e_img.stride) == (16, 4, 64)
    assert img.data.dtype == torch.uint8
    np.testing.assert_array_equal(img.data.numpy(), e_img.data)
    assert img.into_rgba_bytes() is img  # byte images pass through


def test_launch_counter_stays_zero_on_cpu(golden):
    kernels.reset_counts()
    tapi.transcode_uastc_blocks(golden["bc7_in"], "bc7", device=CPU)
    assert kernels.launch_counts() == {t: [0] * 19 for t in kernels.TARGETS}
    assert kernels.plain_call_counts()["bc7"] == [1] * 19
    assert kernels.plain_call_counts()["astc"] == kernels.plain_call_counts()["rgba"] == [0] * 19


def _file(golden):
    return write_uastc_basis([dict(blocks=golden["bc7_in"][:16], nbx=4, nby=4, orig_width=16, orig_height=16)])


_ENDPOINTS = np.array([[1, 2, 3, 4], [31, 0, 17, 7]], np.uint8)
_SELECTORS = np.array([[0, 255, 27, 228]], np.uint8)


def _etc1s_file():
    return write_etc1s_basis(_ENDPOINTS, _SELECTORS, [dict(ep_idx=[0, 1, 1, 0], sel_idx=[0] * 4, nbx=2, nby=2,
                                                           orig_width=8, orig_height=8)])


ENTRY_POINTS = {
    "transcode_uastc_blocks": lambda g: tapi.transcode_uastc_blocks(g["bc7_in"][:4], "bc7"),
    "transcode_uastc_block_to_bc7": lambda g: tapi.transcode_uastc_block_to_bc7(g["bc7_in"][0]),
    "transcode_uastc_block_to_astc": lambda g: tapi.transcode_uastc_block_to_astc(g["astc_in"][0]),
    "unpack_uastc_block_to_rgba": lambda g: tapi.unpack_uastc_block_to_rgba(g["rgba_in"][0]),
    "transcode_uastc_block_to_etc1": lambda g: tapi.transcode_uastc_block_to_etc1(g["etc1_in"][0]),
    "transcode_uastc_block_to_etc2": lambda g: tapi.transcode_uastc_block_to_etc2(g["etc2_in"][0]),
    "read_to_rgba": lambda g: tapi.read_to_rgba(_file(g)),
    "read_to_astc": lambda g: tapi.read_to_astc(_file(g)),
    "read_to_bc7": lambda g: tapi.read_to_bc7(_file(g)),
    "read_to_etc1": lambda g: tapi.read_to_etc1(_file(g)),
    "read_to_etc2": lambda g: tapi.read_to_etc2(_file(g)),
    "read_to_uastc": lambda g: tapi.read_to_uastc(_file(g)),
    "read_to_rgba(etc1s)": lambda g: tapi.read_to_rgba(_etc1s_file()),
    "read_to_etc1(etc1s)": lambda g: tapi.read_to_etc1(_etc1s_file()),
    "run_etc1s_rgba": lambda g: etc1s.run_etc1s_rgba(_ENDPOINTS, _SELECTORS, [0, 1], [0, 0]),
    "run_etc1s_rgba(alpha)": lambda g: etc1s.run_etc1s_rgba(_ENDPOINTS, _SELECTORS, [0, 1], [0, 0],
                                                            alpha_pass=([1, 1], [0, 0])),
    "run_etc1s_etc1": lambda g: etc1s.run_etc1s_etc1(_ENDPOINTS, _SELECTORS, [0, 1], [0, 0]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(golden, entry, monkeypatch):
    # without device= the call asks for the card; with none present it
    # raises instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernels.reset_counts()
    etc1s.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](golden)
    assert sum(sum(c) for c in kernels.plain_call_counts().values()) == 0
    assert sum(etc1s.plain_call_counts().values()) == 0


@pytest.mark.parametrize("target", ["png", "bc1"])
def test_other_targets_not_ported(target):
    with pytest.raises(NotImplementedError, match="unknown target"):
        tapi.transcode_uastc_blocks(np.zeros((1, 16), np.uint8), target, device=CPU)
