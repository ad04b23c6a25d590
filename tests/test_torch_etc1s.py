"""PyTorch port: the ETC1S back-end (basisu_rs_tpu_torch/ops/etc1s.py), the
plain versions of K6-K9 and their wrapper, on the CPU.

Seeded codebooks and index streams (numpy) go through the port's plain
versions and the JAX package's XLA path (`etc1s_{rgba,alpha,etc1}_kernel`,
the composed RGB + alpha merge for K8) and, once a kind, its Pallas kernels
in interpret mode: bit-exact (tolerance 0).  The wrapper's argument, index
range and alignment checks are held as for the UASTC wrappers
(tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basisu_rs_tpu.ops.etc1s as jx
import basisu_rs_tpu.ops.etc1s_pallas as jp
from basisu_rs_tpu_torch.ops import etc1s
from torch_cases import etc1s_inputs as case_inputs

CPU = "cpu"
KINDS = etc1s.KINDS


def plain(kind, endpoints, selectors, idx):
    """The port's plain version of one launch, as numpy uint32 words."""
    ep_tab = etc1s.codebook_tensor(etc1s.pack_endpoints(endpoints), CPU)
    words = etc1s.selector_wire_words(selectors) if kind == "etc1" else etc1s.pack_selectors(selectors)
    sel_tab = etc1s.codebook_tensor(words, CPU)
    streams = [torch.from_numpy(i) for i in idx[: len(etc1s.INDEX_BOOKS[kind])]]
    out = etc1s.etc1s_kernel(kind)(ep_tab, sel_tab, *streams)
    return out.view(torch.uint32).numpy()


def xla(kind, endpoints, selectors, idx):
    """The JAX package's XLA path of the same function."""
    as_i32 = [jnp.asarray(i.astype(np.int32)) for i in idx]
    ep, sel = jnp.asarray(endpoints), jnp.asarray(selectors)
    if kind == "etc1":
        return np.asarray(jx.etc1s_etc1_kernel(ep, jnp.asarray(jx.selector_wire_words_np(selectors)), *as_i32[:2]))
    if kind == "alpha":
        return np.asarray(jx.etc1s_alpha_kernel(ep, sel, *as_i32[:2]))
    rgba = np.asarray(jx.etc1s_rgba_kernel(ep, sel, *as_i32[:2]))
    if kind == "rgba":
        return rgba
    a = np.asarray(jx.etc1s_alpha_kernel(ep, sel, *as_i32[2:]))
    return (rgba & np.uint32(0x00FFFFFF)) | (a << np.uint32(24))


# (E, S, N, seed): one-entry codebooks, small ones, the bench's 2,048 and
# the most a file can hold (u16 counts)
SIZES = [(1, 1, 64, 0), (200, 150, 1000, 1), (2048, 2048, 600, 2), (65535, 65535, 300, 3)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"E{s[0]}-S{s[1]}")
def test_plain_matches_xla(kind, size):
    endpoints, selectors, idx = case_inputs(*size)
    got, expect = plain(kind, endpoints, selectors, idx), xla(kind, endpoints, selectors, idx)
    assert got.dtype == expect.dtype == np.uint32 and got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret(kind):
    endpoints, selectors, idx = case_inputs(150, 90, 300, 7)
    if kind == "etc1":
        ref = jp.etc1s_etc1_pallas(endpoints, jx.selector_wire_words_np(selectors), *idx[:2], interpret=True)
    elif kind == "rgba_alpha":
        ref = jp.etc1s_rgba_alpha_pallas(endpoints, selectors, *idx, interpret=True)
    else:
        fn = jp.etc1s_rgba_pallas if kind == "rgba" else jp.etc1s_alpha_pallas
        ref = fn(endpoints, selectors, *idx[:2], interpret=True)
    np.testing.assert_array_equal(plain(kind, endpoints, selectors, idx), np.asarray(ref))


def test_packers_match_jax():
    endpoints, selectors, _ = case_inputs(300, 257, 1, 4)
    e, s = len(endpoints), len(selectors)
    np.testing.assert_array_equal(etc1s.pack_endpoints(endpoints), jp.pack_endpoints_np(endpoints).reshape(-1)[:e])
    np.testing.assert_array_equal(etc1s.pack_selectors(selectors), jp.pack_selectors_np(selectors).reshape(-1)[:s])
    wire = etc1s.selector_wire_words(selectors)
    assert wire.dtype == np.uint32
    np.testing.assert_array_equal(wire, jx.selector_wire_words_np(selectors))


def test_wire_words_of_every_uniform_selector():
    # a selector of one value everywhere: each of the four wire forms
    # (SELECTOR_ID_TO_ETC1 = [3, 2, 0, 1]: MSB plane, LSB plane)
    rows = np.array([[v * 0x55] * 4 for v in range(4)], np.uint8)
    assert etc1s.selector_wire_words(rows).tolist() == [0xFFFFFFFF, 0x0000FFFF, 0, 0xFFFF0000]


@pytest.mark.parametrize("alpha", [False, True])
def test_run_etc1s_rgba_matches_jax(alpha):
    endpoints, selectors, idx = case_inputs(90, 70, 500, 5)
    alpha_pass = (idx[2], idx[3]) if alpha else None
    got = etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], alpha_pass, device=CPU)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (500, 16) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jx.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], alpha_pass))


def test_run_etc1s_etc1_matches_jax():
    endpoints, selectors, idx = case_inputs(90, 70, 500, 6)
    got = etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1], device=CPU)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (500, 2)
    np.testing.assert_array_equal(got.numpy(), jx.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1]))


def test_entries_take_int64_and_torch_indices():
    endpoints, selectors, idx = case_inputs(20, 10, 50, 8)
    expect = etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], device=CPU)
    as_int64 = etc1s.run_etc1s_rgba(endpoints, selectors, idx[0].astype(np.int64), torch.from_numpy(idx[1]),
                                    device=CPU)
    assert torch.equal(as_int64, expect)
    with pytest.raises(ValueError, match="0..65535"):
        etc1s.run_etc1s_rgba(endpoints, selectors, np.array([70000]), np.array([0]), device=CPU)


def test_counters_on_cpu():
    endpoints, selectors, idx = case_inputs(20, 10, 50, 9)
    etc1s.reset_counts()
    etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], (idx[2], idx[3]), device=CPU)
    etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1], device=CPU)
    assert etc1s.plain_call_counts() == {"rgba": 0, "alpha": 0, "rgba_alpha": 1, "etc1": 1}
    assert etc1s.launch_counts() == {k: 0 for k in KINDS}


def _wrapper_args(kind, n=12):
    endpoints, selectors, idx = case_inputs(9, 5, n, 10)
    ep_tab = etc1s.codebook_tensor(etc1s.pack_endpoints(endpoints), CPU)
    sel_tab = etc1s.codebook_tensor(etc1s.pack_selectors(selectors), CPU)
    return ep_tab, sel_tab, [torch.from_numpy(i) for i in idx[: len(etc1s.INDEX_BOOKS[kind])]]


@pytest.mark.parametrize("kind", KINDS)
def test_index_past_codebook_raises(kind):
    ep_tab, sel_tab, idx = _wrapper_args(kind)
    out = torch.full((12, etc1s.OUT_BYTES[kind]), 0xAB, dtype=torch.uint8)
    etc1s.reset_counts()
    for k, book in enumerate(etc1s.INDEX_BOOKS[kind]):
        bad = [i.clone() for i in idx]
        bad[k][3] = (ep_tab, sel_tab)[book].shape[0]  # one past the end of its codebook
        with pytest.raises(ValueError, match=f"index stream {k} reaches"):
            etc1s.etc1s_kernel(kind)(ep_tab, sel_tab, *bad, out=out)
    assert etc1s.plain_call_counts()[kind] == 0
    assert bool((out == 0xAB).all())  # nothing written
    etc1s.etc1s_kernel(kind)(ep_tab, sel_tab, *idx, out=out, check_index=False)
    assert etc1s.plain_call_counts()[kind] == 1


@pytest.mark.parametrize("case", ["tab_dtype", "idx_dtype", "idx_length", "streams", "out_shape", "out_dtype",
                                  "empty_codebook"])
def test_wrapper_rejects_bad_arguments(case):
    ep_tab, sel_tab, idx = _wrapper_args("rgba")
    out = None
    if case == "tab_dtype":
        ep_tab = ep_tab.to(torch.int64)
    elif case == "idx_dtype":
        idx[0] = idx[0].to(torch.int32)
    elif case == "idx_length":
        idx[1] = idx[1][:-1].contiguous()
    elif case == "streams":
        idx = idx + idx
    elif case == "out_shape":
        out = torch.zeros(12, 8, dtype=torch.uint8)
    elif case == "out_dtype":
        out = torch.zeros(12, 16, dtype=torch.int32)
    else:
        sel_tab = sel_tab[:0]
    with pytest.raises(ValueError):
        etc1s.etc1s_kernel("rgba")(ep_tab, sel_tab, *idx, out=out)


def test_empty_stream_returns_empty_rows():
    ep_tab, sel_tab, _ = _wrapper_args("etc1")
    empty = torch.zeros(0, dtype=torch.uint16)
    out = etc1s.etc1s_kernel("etc1")(ep_tab, sel_tab[:0], empty, empty)
    assert tuple(out.shape) == (0, 8)


def test_no_kernel_for_other_devices():
    # a tensor neither on the CPU nor on a card: no plain fallback
    ep_tab, sel_tab, _ = _wrapper_args("rgba")
    ep_tab, sel_tab = ep_tab.to("meta"), sel_tab.to("meta")
    idx = [torch.zeros(4, dtype=torch.uint16, device="meta")] * 2
    with pytest.raises(ValueError, match="no ETC1S rgba kernel for device meta"):
        etc1s.etc1s_kernel("rgba")(ep_tab, sel_tab, *idx, check_index=False)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset", [0, 8])
def test_out_alignment_rule(kind, offset):
    # 64-byte texel rows go out as 16-byte stores, ETC1's 8-byte rows as one
    # 8-byte store
    width = etc1s.OUT_BYTES[kind]
    base = torch.zeros(3 * width + 32, dtype=torch.uint8)
    lead = (-base.data_ptr()) % 16 + offset
    out = base[lead : lead + 2 * width].view(2, width)
    if offset % min(16, width):
        with pytest.raises(ValueError, match="out must be 16-byte aligned"):
            etc1s.check_out_alignment(out)
    else:
        etc1s.check_out_alignment(out)
