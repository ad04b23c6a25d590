"""Shared inputs and checks of the PyTorch port's per-kernel tests
(tests/test_torch_{bc7,astc,rgba,etc}.py, tests/test_torch_csrc_host.py).

Inputs are made with numpy from a fixed seed: random blocks whose first
byte is one of the mode's 7-bit codes (random pattern fields include
out-of-range ones), plus that mode's golden blocks.  The ETC references
below come from the scalar oracle (tests/oracle_uastc.py), which transcribes
the reference's etc.rs independently of both packages."""

import numpy as np
import torch

import oracle_uastc as ou

from basisu_rs_tpu.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_tpu.ops.dispatch import _mode_kernel
from basisu_rs_tpu.ops.pallas_kernels import pallas_mode_kernel
from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.ops import kernels


def mode_blocks(golden, mode, n_random, seed=0):
    lut = np_tables()["MODE_LUT"]
    rng = np.random.default_rng(seed * 19 + mode)
    codes = np.array([b for b in range(256) if lut[b & 0x7F] == mode], np.uint8)
    r = rng.integers(0, 256, (n_random, 16), dtype=np.uint8)
    r[:, 0] = rng.choice(codes, n_random)
    gold = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == mode]
    return np.ascontiguousarray(np.concatenate([gold, r]))


def plain(target, mode, blocks):
    """The port's plain version of one launch over every row, on the CPU:
    (out uint8 [N, OUT_BYTES], err bool [N]) as numpy."""
    t = torch.from_numpy(blocks)
    out = torch.zeros(len(blocks), kernels.OUT_BYTES[target], dtype=torch.uint8)
    err = torch.zeros(len(blocks), dtype=torch.bool)
    kernels.PLAIN[target](mode, t, None, out, err)
    return out.numpy(), err.numpy()


def jax_xla(target, mode, blocks):
    o, e = _mode_kernel(target, mode, "xla")(lanes_from_bytes_np(blocks, 4))
    return bytes_from_lanes_np(np.asarray(o)), np.asarray(e)


def jax_pallas_interpret(target, mode, blocks):
    o, e = pallas_mode_kernel(target, mode, rows=8, interpret=True)(lanes_from_bytes_np(blocks, 4))
    return bytes_from_lanes_np(np.asarray(o)), np.asarray(e)


def assert_same(label, blocks, got, expect):
    """Bit-exact (tolerance 0) on the output bytes and the err flags."""
    (out, err), (e_out, e_err) = got, expect
    bad = np.nonzero(np.any(out != e_out, axis=1) | (err != e_err))[0]
    assert bad.size == 0, (
        f"{label}: {bad.size}/{len(blocks)} blocks differ; first {blocks[bad[0]].tolist()}\n"
        f"got {out[bad[0]].tolist()} err {err[bad[0]]}\nexp {e_out[bad[0]].tolist()} err {e_err[bad[0]]}"
    )


def eac_reference_selectors(tbl, mult):
    """uint8 [256 centre, 256 alpha]: the reference's EAC selector, the first
    j minimising |clamp(centre + mod[j]*mult) - alpha| (min_by_key,
    etc.rs:315-323)."""
    mods = np.asarray(ou._ETC2_ALPHA_MODIFIERS[tbl])[:, None, None]
    center = np.arange(256)[None, :, None]
    alpha = np.arange(256)[None, None, :]
    vals = np.clip(center + mods * mult, 0, 255)
    return np.argmin(np.abs(vals - alpha), axis=0).astype(np.uint8)


def etc1_selector_cases():
    """(lum int32 [n], thresholds int32 [n, 3], expected uint8 [n]): every
    luminance -1..11 against every non-decreasing threshold triple in 0..10,
    expected = ms | ls << 1 of the reference's SELECTOR_ID_TO_ETC1[sel], sel
    = the number of thresholds the luminance reaches (etc.rs:181-190)."""
    th = np.array([(a, b, c) for a in range(11) for b in range(a, 11) for c in range(b, 11)], np.int32)
    lum = np.arange(-1, 12, dtype=np.int32)
    th_all = np.repeat(th, len(lum), axis=0)
    lum_all = np.tile(lum, len(th))
    sel = (lum_all[:, None] >= th_all).sum(1)
    mod_id = np.asarray(ou._SELECTOR_ID_TO_ETC1)[sel]
    return lum_all, np.ascontiguousarray(th_all), ((mod_id >> 1) | ((mod_id & 1) << 1)).astype(np.uint8)


def bias_reference(bias, limit, subblock, channel):
    """int [limit + 1]: the reference's bias nudge of v = 0..limit
    (oracle_uastc._apply_etc1_bias)."""
    return np.array([ou._apply_etc1_bias([v, v, v], bias, limit, subblock)[channel] for v in range(limit + 1)])


def etc1s_codebooks(rng, e, s):
    """Seeded ETC1S codebooks: endpoints uint8 [e, 4] (r5, g5, b5, inten3)
    and selectors uint8 [s, 4] row bytes, as tests/test_etc1s_oracle.py
    makes them."""
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    return endpoints, rng.integers(0, 256, (s, 4)).astype(np.uint8)


def etc1s_inputs(e, s, n, seed):
    """(endpoints, selectors, [ep, sel, alpha ep, alpha sel] uint16 [n])."""
    rng = np.random.default_rng(seed)
    endpoints, selectors = etc1s_codebooks(rng, e, s)
    return endpoints, selectors, [rng.integers(0, m, n).astype(np.uint16) for m in (e, s, e, s)]
