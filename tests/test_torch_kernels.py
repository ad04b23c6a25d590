"""PyTorch port: the kernel wrappers of `ops/kernels.py` (argument checks,
the in-place index contract, counters, the output alignment rule, which
launches the dispatch chains) and the
native build helper of `ops/build.py`, on the CPU, where a wrapper runs its
plain version."""

import shutil

import numpy as np
import pytest
import torch

from basisu_rs_tpu_torch.ops import build, kernels

from torch_cases import mode_blocks, plain

TARGETS = kernels.TARGETS


def _args(golden, target, mode=3, n_random=40):
    blocks = torch.from_numpy(mode_blocks(golden, mode, n_random))
    n = blocks.shape[0]
    out = torch.full((n, kernels.OUT_BYTES[target]), 0xAB, dtype=torch.uint8)
    err = torch.zeros(n, dtype=torch.bool)
    return blocks, out, err


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("where", ["negative", "past_end"])
def test_index_out_of_range_raises(golden, target, where):
    blocks, out, err = _args(golden, target)
    bad = -1 if where == "negative" else blocks.shape[0]
    index = torch.tensor([0, bad, 2], dtype=torch.int64)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="index values must lie in"):
        kernels.mode_kernel(target, 3)(blocks, index, out, err)
    assert kernels.plain_call_counts()[target][3] == 0
    assert bool((out == 0xAB).all())  # nothing written


@pytest.mark.parametrize("target", TARGETS)
def test_index_rows_in_place(golden, target):
    # rows named by the index get the plain version's result; the others keep
    # what was in `out`
    blocks, out, err = _args(golden, target)
    index = torch.arange(1, blocks.shape[0], 3)
    kernels.reset_counts()
    kernels.mode_kernel(target, 3)(blocks, index, out, err)
    assert kernels.plain_call_counts()[target][3] == 1
    e_out, e_err = plain(target, 3, blocks.numpy())
    rows = index.numpy()
    np.testing.assert_array_equal(out.numpy()[rows], e_out[rows])
    np.testing.assert_array_equal(err.numpy()[rows], e_err[rows])
    rest = np.setdiff1d(np.arange(blocks.shape[0]), rows)
    assert bool((out[torch.from_numpy(rest)] == 0xAB).all())
    assert not bool(err[torch.from_numpy(rest)].any())


@pytest.mark.parametrize("case", ["blocks_dtype", "blocks_width", "index_dtype", "out_shape", "err_dtype"])
def test_wrapper_rejects_bad_arguments(golden, case):
    blocks, out, err = _args(golden, "rgba")
    index = None
    if case == "blocks_dtype":
        blocks = blocks.to(torch.int16)
    elif case == "blocks_width":
        blocks = blocks[:, :8].contiguous()
    elif case == "index_dtype":
        index = torch.arange(4, dtype=torch.int32)
    elif case == "out_shape":
        out = out[:, :16].contiguous()
    else:
        err = err.to(torch.uint8)
    with pytest.raises(ValueError):
        kernels.mode_kernel("rgba", 3)(blocks, index, out, err)


@pytest.mark.parametrize("target", TARGETS)
def test_output_rows_have_out_bytes(golden, target):
    # the wrapper allocates [N, OUT_BYTES] rows (8 for ETC1) and refuses an
    # out tensor of another row width
    blocks, _, _ = _args(golden, target)
    out, err = kernels.mode_kernel(target, 3)(blocks)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (blocks.shape[0], kernels.OUT_BYTES[target])
    np.testing.assert_array_equal(out.numpy(), plain(target, 3, blocks.numpy())[0])
    wrong = torch.zeros(blocks.shape[0], 24, dtype=torch.uint8)
    with pytest.raises(ValueError, match=f"uint8 \\[N, {kernels.OUT_BYTES[target]}\\]"):
        kernels.mode_kernel(target, 3)(blocks, None, wrong, err)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("offset", [0, 4, 8])
def test_alignment_rule(target, offset):
    # blocks 16-byte aligned; out aligned to min(16, its row bytes): an ETC1
    # row may start 8 bytes into a 16-byte line, no other target's may
    blocks = torch.zeros(4, 16, dtype=torch.uint8)
    width = kernels.OUT_BYTES[target]
    base = torch.zeros(5 * width + 16, dtype=torch.uint8)
    lead = (-base.data_ptr()) % 16 + offset
    out = base[lead : lead + 4 * width].view(4, width)
    if offset % min(16, width):
        with pytest.raises(ValueError, match="out must be"):
            kernels.check_alignment(blocks, out)
    else:
        kernels.check_alignment(blocks, out)
    shifted = torch.zeros(5 * 16 + 16, dtype=torch.uint8)
    lead = (-shifted.data_ptr()) % 16 + 8
    with pytest.raises(ValueError, match="blocks must be 16-byte aligned"):
        kernels.check_alignment(shifted[lead : lead + 64].view(4, 16), out)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed; host_library builds with it")
def test_host_library_raises_on_failed_build(tmp_path):
    src = tmp_path / "broken_unit.cpp"
    src.write_text('extern "C" int broken( { return 0; }\n')
    with pytest.raises(RuntimeError, match="build of libbroken_unit_.*failed"):
        build.host_library(src)
    assert not list(build.BUILD.glob("libbroken_unit_*"))  # no partial library left


@pytest.mark.parametrize("target", TARGETS)
def test_dispatch_chains_each_launch_after_the_first(golden, target, monkeypatch):
    # the dispatch's launches (on the CPU, BC7's through the tile kernel's
    # plain path): one a present mode, in mode order, each a plain launch
    # (the kernel wrappers chain none)
    from basisu_rs_tpu_torch.ops import dispatch

    calls = []

    def fake(self, blocks, index=None, out=None, err=None, check_index=True):
        calls.append(self.mode)

    monkeypatch.setattr(kernels.ModeKernel, "__call__", fake)
    blocks = torch.from_numpy(np.ascontiguousarray(golden["bc7_in"]))
    dispatch.transcode_blocks(blocks, target)
    assert calls == sorted(set(calls)) and len(calls) > 2


def _tile_args(golden):
    """Golden blocks in a seeded random order with an invalid-mode block."""
    rng = np.random.default_rng(23)
    blocks = golden["bc7_in"][rng.integers(0, len(golden["bc7_in"]), 300)]
    blocks[17, 0] = 69  # MODE_LUT[69] = 19, the invalid mode
    return torch.from_numpy(np.ascontiguousarray(blocks))


@pytest.mark.parametrize("case", ["blocks_dtype", "blocks_width", "blocks_strided", "out_shape", "err_dtype"])
def test_tile_wrapper_rejects_bad_arguments(golden, case):
    # the tile kernel's wrapper checks its arguments as ModeKernel does,
    # before anything runs
    blocks = _tile_args(golden)
    out = torch.full((blocks.shape[0], 16), 0xAB, dtype=torch.uint8)
    err = torch.zeros(blocks.shape[0], dtype=torch.bool)
    if case == "blocks_dtype":
        blocks = blocks.to(torch.int16)
    elif case == "blocks_width":
        blocks = blocks[:, :8].contiguous()
    elif case == "blocks_strided":
        blocks = blocks[::2]
        out, err = out[::2].contiguous(), err[::2].contiguous()
    elif case == "out_shape":
        out = out[:-1]
    else:
        err = err.to(torch.uint8)
    kernels.reset_counts()
    with pytest.raises(ValueError):
        kernels.tile_kernel("bc7")(blocks, out, err)
    assert sum(kernels.plain_call_counts()["bc7"]) == 0
    if out.dtype == torch.uint8:
        assert bool((out == 0xAB).all())


def test_tile_wrapper_takes_the_plain_path_on_the_cpu(golden):
    # a CPU tensor: the dispatch's partition and one plain call a present
    # mode, no launch; the invalid block's row zero with err, the golden
    # blocks' rows their golden outputs; an empty batch does nothing
    from basisu_rs_tpu_torch.ops.dispatch import block_modes

    blocks = _tile_args(golden)
    kernels.reset_counts()
    out, err = kernels.tile_kernel("bc7")(blocks)
    assert kernels.tile_launch_counts() == {"bc7": 0} and sum(map(sum, kernels.launch_counts().values())) == 0
    assert sum(kernels.plain_call_counts()["bc7"]) == len(set(block_modes(blocks).tolist()) - {19})
    assert err.tolist() == [i == 17 for i in range(blocks.shape[0])]
    assert not bool(out[17].any())
    gold = {bytes(b): o for b, o in zip(golden["bc7_in"], golden["bc7_out"].view(np.uint8).reshape(-1, 16))}
    rows = [i for i in range(blocks.shape[0]) if i != 17]
    np.testing.assert_array_equal(out.numpy()[rows], [gold[bytes(blocks[i].numpy())] for i in rows])
    empty_out, empty_err = kernels.tile_kernel("bc7")(blocks[:0])
    assert empty_out.shape == (0, 16) and empty_err.shape == (0,)
    assert kernels.TILED == frozenset(build.LAUNCH_TILES) == {"bc7"}


def test_tile_wrapper_refuses_a_device_without_its_kernel():
    blocks = torch.zeros(4, 16, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no bc7 kernel for device meta"):
        kernels.tile_kernel("bc7")(blocks)
