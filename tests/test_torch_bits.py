"""PyTorch port: bit helpers (basisu_rs_tpu_torch/ops/bits.py) against the
JAX package's ops/bits.py on seeded random words, bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basisu_rs_tpu.ops import bits as jb
from basisu_rs_tpu_torch.ops import bits as tb

N = 64


def _lanes(seed):
    words = np.random.default_rng(seed).integers(0, 2**32, (N, 4), dtype=np.uint32)
    return words, torch.from_numpy(words.astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize(
    "offset,count",
    [(0, 1), (0, 32), (5, 0), (31, 1), (31, 2), (30, 8), (32, 32), (33, 31), (60, 8),
     (64, 5), (95, 3), (96, 32), (120, 8), (126, 5), (127, 1), (128, 4)],
)
def test_extract(offset, count):
    words, lanes = _lanes(offset * 33 + count)
    expect = _np(jb.extract(jnp.asarray(words), offset, count))
    np.testing.assert_array_equal(tb.extract(lanes, offset, count).numpy(), expect)


@pytest.mark.parametrize("count", [1, 5, 8, 31, 32])
@pytest.mark.parametrize("bounded", [False, True])
def test_extract_dyn(count, bounded):
    words, lanes = _lanes(count + 100 * bounded)
    rng = np.random.default_rng(count)
    lo, hi = (28, 70) if bounded else (0, 127)
    offs = rng.integers(lo, hi + 1, N).astype(np.int32)
    offs[:4] = [32, 64, lo, hi]  # word edges: b == 0
    bit_range = (lo, hi) if bounded else None
    expect = _np(jb.extract_dyn(jnp.asarray(words), jnp.asarray(offs), count, bit_range))
    got = tb.extract_dyn(lanes, torch.from_numpy(offs), count, bit_range)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("bit_range", [(3, 20), (20, 70), (60, 128)])
def test_extract_bit_dyn(bit_range):
    words, lanes = _lanes(bit_range[0])
    offs = np.random.default_rng(7).integers(bit_range[0], bit_range[1], N).astype(np.int32)
    expect = _np(jb.extract_bit_dyn(jnp.asarray(words), jnp.asarray(offs), bit_range))
    got = tb.extract_bit_dyn(lanes, torch.from_numpy(offs), bit_range)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_lane_writer():
    rng = np.random.default_rng(11)
    jw = jb.LaneWriter((N,), 4)
    tw = tb.LaneWriter((N,), 4, torch.device("cpu"))
    for offset, count in [(0, 7), (7, 14), (21, 32), (60, 8), (94, 5), (120, 12), (127, 3)]:
        v = rng.integers(0, 2**32, N, dtype=np.uint32)
        jw.put(jnp.asarray(v), offset, count)
        tw.put(torch.from_numpy(v.astype(np.int64)), offset, count)
    for offset, count, value in [(3, 2, 3), (30, 4, 0xF), (100, 32, 0xDEADBEEF)]:
        jw.put_const(value, offset, count)
        tw.put_const(value, offset, count)
    for lo, hi, count in [(32, 70, 6), (0, 127, 32), (60, 64, 3)]:
        v = rng.integers(0, 2**32, N, dtype=np.uint32)
        offs = rng.integers(lo, hi + 1, N).astype(np.int32)
        offs[:2] = [lo, 64]
        jw.put_dyn(jnp.asarray(v), jnp.asarray(offs), count, bit_range=(lo, hi))
        tw.put_dyn(torch.from_numpy(v.astype(np.int64)), torch.from_numpy(offs), count, bit_range=(lo, hi))
    np.testing.assert_array_equal(tw.stack().numpy(), _np(jw.stack()))


@pytest.mark.parametrize("count", range(1, 9))
def test_bitrev(count):
    v = np.arange(512, dtype=np.uint32)
    expect = _np(jb.bitrev(jnp.asarray(v), count))
    np.testing.assert_array_equal(tb.bitrev(torch.arange(512), count).numpy(), expect)


def test_fl_div255_exhaustive():
    x = np.arange(256)
    expect = (x.astype(np.float32) / np.float32(255.0)).astype(np.float32)
    got = tb.fl_div255(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))


def test_bytes_lanes_round_trip():
    blocks = np.random.default_rng(3).integers(0, 256, (N, 16), dtype=np.uint8)
    lanes = tb.lanes_from_bytes(torch.from_numpy(blocks), 4)
    np.testing.assert_array_equal(lanes.numpy(), jb.lanes_from_bytes_np(blocks, 4).astype(np.int64))
    np.testing.assert_array_equal(tb.bytes_from_lanes(lanes).numpy(), blocks)
