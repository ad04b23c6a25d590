"""PyTorch port: multi-device sharding (basisu_rs_tpu_torch/parallel/mesh.py)
on the CPU, against the port's single-device path and the JAX package.

Meshes are lists of CPU "devices" (`make_mesh(n, allow_cpu_fallback=True)`,
n = 3 and 8, so that block counts do not divide), where every shard runs
the kernels' plain versions.  Inputs are made with numpy from a seed.
Everything is bit-exact (tolerance 0): the sharded UASTC path for the five
targets against the port's `transcode_blocks`, the golden outputs and the
JAX package (its `sharded_transcode` on the 8-device CPU mesh for bc7 and
etc1, its per-mode XLA kernels elsewhere), the step functions, the sharded
ETC1S path against the JAX package's, the file readers with `mesh=`, and
the empty batch and short batches.  JAX compiles each function once, in
module-scoped fixtures."""

import warnings

import numpy as np
import pytest
import torch

import basisu_rs_tpu.container.basis as jb
import basisu_rs_tpu.parallel.mesh as jm
import basisu_rs_tpu_torch as tb
import basisu_rs_tpu_torch.container.writer as tw
import basisu_rs_tpu_torch.parallel.mesh as pm
from basisu_rs_tpu.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_tpu.tables import MODES, np_tables
from basisu_rs_tpu_torch.api import BasisError
from basisu_rs_tpu_torch.ops import etc1s, kernels
from basisu_rs_tpu_torch.ops.dispatch import transcode_blocks
from basisu_rs_tpu_torch.base import resolve_device
from basisu_rs_tpu_torch.parallel import (
    make_mesh,
    shard_blocks,
    sharded_etc1s_transcode,
    sharded_transcode,
    sharded_transcode_step,
)
from basisu_rs_tpu_torch.utils import profiling
from torch_cases import jax_xla

TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")
MESH_SIZES = (3, 8)
SEED = 0x9A7


@pytest.fixture(scope="module")
def meshes():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {n: make_mesh(n, allow_cpu_fallback=True) for n in MESH_SIZES}


@pytest.fixture(scope="module")
def jax_mesh():
    return jm.make_mesh(8)


@pytest.fixture(scope="module")
def blocks(golden):
    """The 608 golden blocks (every mode) plus 3 seeded random blocks."""
    rng = np.random.default_rng(SEED)
    return np.ascontiguousarray(np.concatenate([golden["bc7_in"], rng.integers(0, 256, (3, 16), dtype=np.uint8)]))


@pytest.fixture(scope="module")
def jax_sharded(blocks, jax_mesh):
    return {t: jm.sharded_transcode(blocks, t, jax_mesh) for t in ("bc7", "etc1")}


def _bytes(out) -> np.ndarray:
    """A port result (torch, uint8 rows or uint32 RGBA words) as uint8 rows."""
    return out.contiguous().view(torch.uint8).numpy()


def _jax_expected(golden, blocks, target):
    """(bytes, err) the JAX package's transcode_blocks gives: the golden
    outputs for the golden rows, its per-mode XLA kernel for the others
    (zero rows with err for mode 19)."""
    n_gold = len(golden["bc7_in"])
    out = [golden[f"{target}_out"].view(np.uint8).reshape(n_gold, kernels.OUT_BYTES[target])]
    err = [np.zeros(n_gold, bool)]
    lut = np_tables()["MODE_LUT"]
    for b in blocks[n_gold:]:
        mode = int(lut[b[0] & 0x7F])
        if mode == 19:
            o, e = np.zeros((1, kernels.OUT_BYTES[target]), np.uint8), np.ones(1, bool)
        else:
            o, e = jax_xla(target, mode, b[None])
        out.append(o)
        err.append(e)
    return np.concatenate(out), np.concatenate(err)


def _invalid_pattern_block() -> np.ndarray:
    """A mode-2 block whose pattern field is 31 (mode 2 has 30 patterns)."""
    b = np.zeros(16, np.uint8)
    b[0] = 0x1D
    ofs = MODES[2].field_offsets["pattern"]
    for k in range(5):
        b[(ofs + k) // 8] |= 1 << ((ofs + k) % 8)
    return b


# ---------------------------------------------------------------------------
# sharded_transcode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("target", TARGETS)
def test_sharded_transcode_matches_single_device(golden, blocks, meshes, target, n):
    """Every mode of the golden mix plus 3 seeded blocks, 611 rows over 3 or
    8 devices: the port's single-device result and the JAX package's."""
    out, err = sharded_transcode(blocks, target, meshes[n])
    ref_out, ref_err = transcode_blocks(torch.from_numpy(blocks), target)
    assert out.dtype == ref_out.dtype and out.shape == ref_out.shape and out.device.type == "cpu"
    assert torch.equal(out, ref_out) and torch.equal(err, ref_err)
    j_out, j_err = _jax_expected(golden, blocks, target)
    np.testing.assert_array_equal(_bytes(out), j_out)
    np.testing.assert_array_equal(err.numpy(), j_err)


@pytest.mark.parametrize("target", ["bc7", "etc1"])
def test_sharded_transcode_matches_jax_sharded(blocks, meshes, jax_sharded, target):
    out, err = sharded_transcode(blocks, target, meshes[8])
    j_out, j_err = jax_sharded[target]
    assert np.asarray(j_out).dtype == np.uint8  # block bytes, as transcode_blocks returns them
    np.testing.assert_array_equal(_bytes(out), np.asarray(j_out))
    np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_sharded_transcode_flags_invalid_blocks_in_order(golden, meshes, n):
    blocks = golden["rgba_in"][:64].copy()
    blocks[5, 0] = 69  # MODE_LUT entry 19: invalid mode
    blocks[40] = _invalid_pattern_block()
    out, err = sharded_transcode(blocks, "rgba", meshes[n])
    assert torch.nonzero(err).flatten().tolist() == [5, 40]
    assert not out[5].any()
    ref_out, ref_err = transcode_blocks(torch.from_numpy(blocks), "rgba")
    assert torch.equal(out, ref_out) and torch.equal(err, ref_err)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_empty_and_short_batches(meshes, n):
    for target in TARGETS:
        out, err = sharded_transcode(np.zeros((0, 16), np.uint8), target, meshes[n])
        ref_out, _ = transcode_blocks(torch.zeros(0, 16, dtype=torch.uint8), target)
        assert out.shape == ref_out.shape and out.dtype == ref_out.dtype and err.shape == (0,)
    blocks = np.load("tests/fixtures/golden_blocks.npz")["etc1_in"][100:103]  # fewer blocks than devices
    out, err = sharded_transcode(blocks, "etc1", meshes[n])
    ref_out, ref_err = transcode_blocks(torch.from_numpy(blocks), "etc1")
    assert torch.equal(out, ref_out) and torch.equal(err, ref_err)
    shards = shard_blocks(blocks, meshes[n])
    assert len(shards) == n and all(s.shape == (1, 16) for s in shards)
    assert all(not s.any() for s in shards[3:])  # zero pad rows
    got = sharded_etc1s_transcode("etc1", np.zeros((1, 4), np.uint8), np.zeros((1, 4), np.uint8),
                                  np.zeros(0, np.uint16), np.zeros(0, np.uint16), meshes[n])
    assert got.shape == (0, 2) and got.dtype == torch.uint32


def test_shard_blocks_pads_as_jax(blocks, meshes, jax_mesh):
    shards = shard_blocks(blocks, meshes[8])
    assert [s.shape for s in shards] == [(77, 16)] * 8
    j = bytes_from_lanes_np(np.asarray(jm.shard_blocks(lanes_from_bytes_np(blocks, 4), jax_mesh)))
    np.testing.assert_array_equal(torch.cat(shards).numpy(), j)


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", range(19))
def test_sharded_mode_step(golden, meshes, mode):
    """One mode's golden blocks tiled to 35 rows (no mesh size divides it):
    one unindexed launch a shard, against the golden outputs."""
    lut = np_tables()["MODE_LUT"]
    sel = lut[golden["bc7_in"][:, 0] & 0x7F] == mode
    blocks = np.resize(golden["bc7_in"][sel], (35, 16))
    expected = np.resize(golden["bc7_out"][sel], (35, 16))
    n = 3 if mode % 2 else 8
    kernels.reset_counts()
    out, err, total = pm.sharded_mode_step("bc7", mode, meshes[n])(blocks)
    # one call a non-empty shard: 12 + 12 + 11 rows, or 7 x 5 rows and an empty shard
    assert kernels.plain_call_counts()["bc7"][mode] == len(range(0, 35, -(-35 // n)))
    assert total == 0 and not err.any()
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_sharded_transcode_step_counts_errors(golden, meshes, n):
    blocks = golden["rgba_in"][:64].copy()
    blocks[3, 0] = 69
    blocks[10, 0] = 69
    shards = shard_blocks(blocks, meshes[n])
    out, count = sharded_transcode_step("rgba", meshes[n])(shards)
    padded = torch.cat(shards)
    ref_out, ref_err = transcode_blocks(padded, "rgba")
    assert count == int(ref_err.sum()) == 2  # the zero pad rows (mode 11) transcode without err
    assert torch.equal(out, ref_out)
    with pytest.raises(ValueError, match="shards"):
        sharded_transcode_step("rgba", meshes[n])(shards[:-1])


def test_sharded_transcode_step_matches_jax(golden, meshes, jax_mesh):
    """253 blocks with two invalid ones, padded to 256 over 8 devices by
    both packages' shard_blocks: the same outputs and error count."""
    blocks = golden["bc7_in"][:253].copy()
    blocks[7, 0] = 69
    blocks[200] = _invalid_pattern_block()
    out, count = sharded_transcode_step("bc7", meshes[8])(shard_blocks(blocks, meshes[8]))
    j_out, j_count = jm.sharded_transcode_step("bc7", jax_mesh)(jm.shard_blocks(lanes_from_bytes_np(blocks, 4), jax_mesh))
    assert count == int(j_count) == 2
    np.testing.assert_array_equal(out.numpy(), bytes_from_lanes_np(np.asarray(j_out)))


# ---------------------------------------------------------------------------
# ETC1S: codebooks on every device, index streams split
# ---------------------------------------------------------------------------


def _etc1s_inputs(seed, n=1000, n_endpoints=37, n_selectors=53):
    rng = np.random.default_rng(seed)
    endpoints = np.stack([rng.integers(0, 32, n_endpoints), rng.integers(0, 32, n_endpoints),
                          rng.integers(0, 32, n_endpoints), rng.integers(0, 8, n_endpoints)], axis=-1).astype(np.uint8)
    selectors = rng.integers(0, 256, (n_selectors, 4), dtype=np.uint8)
    idx = [rng.integers(0, size, n, dtype=np.int32) for size in (n_endpoints, n_selectors) * 2]
    return endpoints, selectors, idx


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", ["rgba", "alpha", "etc1", "rgba_alpha"])
def test_sharded_etc1s_matches_single_device_and_jax(meshes, jax_mesh, kind, n):
    endpoints, selectors, idx = _etc1s_inputs(SEED + len(kind))
    extra = tuple(idx[2:]) if kind == "rgba_alpha" else ()
    etc1s.reset_counts()
    got = sharded_etc1s_transcode(kind, endpoints, selectors, idx[0], idx[1], meshes[n], extra_idx=extra)
    assert etc1s.plain_call_counts()[kind] == n
    if kind == "etc1":
        ref = etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1], "cpu")
    elif kind == "alpha":
        ep, sel = (etc1s.codebook_tensor(w, "cpu") for w in (etc1s.pack_endpoints(endpoints),
                                                             etc1s.pack_selectors(selectors)))
        ref = etc1s.etc1s_kernel("alpha")(ep, sel, *(etc1s.index_tensor(i, "cpu") for i in idx[:2])).view(torch.uint32)
    else:
        ref = etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], extra or None, "cpu")
    assert got.dtype == torch.uint32 and torch.equal(got, ref)
    j = jm.sharded_etc1s_transcode(kind, endpoints, selectors, idx[0], idx[1], jax_mesh, extra_idx=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


def test_sharded_etc1s_checks_indices(meshes):
    endpoints, selectors, idx = _etc1s_inputs(SEED)
    idx[1][900] = 53  # past the 53-entry selector codebook, in the last shard
    with pytest.raises(ValueError, match="past its codebook"):
        sharded_etc1s_transcode("rgba", endpoints, selectors, idx[0], idx[1], meshes[3])
    with pytest.raises(ValueError, match="different lengths"):
        sharded_etc1s_transcode("rgba", endpoints, selectors, idx[0], idx[1][:-1], meshes[3])
    with pytest.raises(ValueError, match="unknown ETC1S kind"):
        sharded_etc1s_transcode("bc7", endpoints, selectors, idx[0], idx[1], meshes[3])


# ---------------------------------------------------------------------------
# one device: the entries are the one-device mesh
# ---------------------------------------------------------------------------


def _recorded(call):
    """(output, the spans below the root in start order, counter totals) of
    one call with the recorder on."""
    profiling.clear()
    profiling.enable()
    try:
        out = call()
        rec = profiling.records()
    finally:
        profiling.disable()
        profiling.clear()
    (root,) = [s for s in rec.spans if s.parent is None]
    below = [s.name for s in sorted(rec.spans, key=lambda s: (s.start_ns, s.id)) if s is not root]
    return out, (root.name, below), {name: rec.total(name) for _request, name in rec.counts}


@pytest.mark.parametrize("fmt", ["uastc-bc7", "etc1s-rgba"])
def test_one_device_entry_runs_the_one_device_mesh(golden, fmt):
    """transcode_uastc_blocks / run_etc1s_rgba and sharded_transcode /
    sharded_etc1s_transcode over (cpu,): the same spans below their roots,
    in the same order, the same counter totals and equal outputs."""
    cpu = (torch.device("cpu"),)
    blocks = golden["bc7_in"]
    endpoints, selectors, idx = _etc1s_inputs(SEED + 3)
    entry, mesh = {
        "uastc-bc7": (lambda: tb.transcode_uastc_blocks(blocks, "bc7", "cpu"),
                      lambda: sharded_transcode(blocks, "bc7", cpu)),
        "etc1s-rgba": (lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], device="cpu"),
                       lambda: sharded_etc1s_transcode("rgba", endpoints, selectors, idx[0], idx[1], cpu)),
    }[fmt]
    one_out, (one_root, one_spans), one_counts = _recorded(entry)
    mesh_out, (mesh_root, mesh_spans), mesh_counts = _recorded(mesh)
    assert (one_root, mesh_root) == {"uastc-bc7": ("api.transcode", "parallel.transcode"),
                                     "etc1s-rgba": ("etc1s.run", "parallel.etc1s")}[fmt]
    assert one_spans == mesh_spans and one_spans
    assert one_counts == mesh_counts and one_counts["host_syncs"] > 0
    for a, b in zip(*((o if isinstance(o, tuple) else (o,)) for o in (one_out, mesh_out))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resolve_device_names_the_card(monkeypatch):
    """"cuda" resolves to the current card's index, as a mesh's devices do,
    so a one-device entry writes its shard's rows in place; without a card
    it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == torch.device("cuda", 1) == pm.resolve_mesh("cuda")[0]
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


# ---------------------------------------------------------------------------
# read_to_* with mesh=
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(blocks):
    """A UASTC file of two slices over the 611 blocks, shuffled, and ETC1S
    files: one with two RGB + alpha slice pairs, one with three slices."""
    rng = np.random.default_rng(SEED + 1)
    perm = rng.permutation(len(blocks))
    uastc = tw.write_uastc_basis([
        dict(blocks=blocks[perm[:299]], nbx=13, nby=23, orig_width=52, orig_height=90),
        dict(blocks=blocks[perm[299:]], nbx=24, nby=13, orig_width=96, orig_height=49),
    ])
    endpoints, selectors, _ = _etc1s_inputs(SEED + 2)
    dims = [(9, 7), (5, 3)]

    def sl(nbx, nby, alpha=False):
        return dict(ep_idx=rng.integers(0, 37, nbx * nby), sel_idx=rng.integers(0, 53, nbx * nby), nbx=nbx,
                    nby=nby, orig_width=4 * nbx - 1, orig_height=4 * nby, alpha=alpha)

    alpha = tw.write_etc1s_basis(endpoints, selectors, [sl(*d, a) for d in dims for a in (False, True)],
                                 has_alpha=True)
    plain = tw.write_etc1s_basis(endpoints, selectors, [sl(*d) for d in dims + [(1, 1)]])
    return {"uastc": uastc, "etc1s_alpha": alpha, "etc1s": plain}


@pytest.fixture(scope="module")
def jax_reads(files, jax_mesh):
    return {(name, reader): getattr(jb, reader)(buf, mesh=jax_mesh)
            for name, buf in files.items()
            for reader in ("read_to_bc7", "read_to_rgba", "read_to_etc1")
            if name == "uastc" or reader != "read_to_bc7"}


def _images(result):
    return result[1] if isinstance(result, tuple) else result


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name,reader", [("uastc", "read_to_bc7"), ("uastc", "read_to_rgba"), ("uastc", "read_to_etc1"),
                                         ("etc1s_alpha", "read_to_rgba"), ("etc1s_alpha", "read_to_etc1"),
                                         ("etc1s", "read_to_rgba"), ("etc1s", "read_to_etc1")])
def test_read_with_mesh_matches(files, jax_reads, meshes, name, reader, n):
    """The reads with mesh= equal the reads without one and the JAX
    package's reads on its 8-device mesh; device="cuda" beside the mesh
    needs no card (the mesh decides)."""
    buf = files[name]
    sharded = _images(getattr(tb, reader)(buf, device="cuda", mesh=meshes[n]))
    single = _images(getattr(tb, reader)(buf, device="cpu"))
    ref = _images(jax_reads[(name, reader)])
    assert len(sharded) == len(single) == len(ref) > 0
    for img, one, j in zip(sharded, single, ref):
        assert (img.w, img.h, img.stride) == (one.w, one.h, one.stride) == (j.w, j.h, j.stride)
        assert img.data.device.type == "cpu" and torch.equal(img.data, one.data)
        np.testing.assert_array_equal(img.data.numpy(), np.asarray(j.data))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_read_with_mesh_names_the_first_failing_block(golden, meshes, n):
    """An invalid mode and an invalid pattern in different slices and
    shards: the message is the first failing block's in slice order, either
    way round."""
    base = golden["bc7_in"][:96]
    for first, later, msg in ((69, "pattern", "invalid mode index"), ("pattern", 69, "block pattern is not valid")):
        blocks = base.copy()
        for row, bad in ((20, first), (90, later)):
            if bad == 69:
                blocks[row, 0] = 69
            else:
                blocks[row] = _invalid_pattern_block()
        buf = tw.write_uastc_basis([dict(blocks=blocks[:48], nbx=8, nby=6, orig_width=32, orig_height=24),
                                    dict(blocks=blocks[48:], nbx=6, nby=8, orig_width=24, orig_height=32)])
        for reader in ("read_to_bc7", "read_to_rgba", "read_to_etc1"):
            with pytest.raises(BasisError, match=msg):
                getattr(tb, reader)(buf, mesh=meshes[n])


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------


def test_make_mesh_refuses_silent_cpu_fallback(monkeypatch):
    """With fewer CUDA devices than asked for, make_mesh raises unless the
    caller opts in with allow_cpu_fallback=True, and warns loudly even
    then."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="allow_cpu_fallback"):
        make_mesh(8)
    with pytest.raises(ValueError, match="allow_cpu_fallback"):
        make_mesh()
    with pytest.warns(UserWarning, match="CPU devices"):
        mesh = make_mesh(8, allow_cpu_fallback=True)
    assert mesh == (torch.device("cpu"),) * 8


def test_make_mesh_raises_when_too_few_devices(monkeypatch):
    """The cards first, with explicit indices, and a raise past their count.
    JAX's second limit (too few virtual CPU devices) has no counterpart:
    the port's CPU "devices" are one device named n times, so the fallback
    grants any count (the port's own rule, in make_mesh's docstring); a
    count below 1 is refused either way."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1) == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested a 3-device mesh but CUDA has 2 device"):
        make_mesh(3)
    with pytest.warns(UserWarning):
        assert make_mesh(64, allow_cpu_fallback=True) == (torch.device("cpu"),) * 64
    for n in (0, -1):
        with pytest.raises(ValueError, match="at least one device"):
            make_mesh(n, allow_cpu_fallback=True)


def test_mesh_devices_normalised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert pm.mesh_devices(["cuda", "cuda:0", torch.device("cpu")]) == (
        torch.device("cuda", 1), torch.device("cuda", 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one device"):
        pm.mesh_devices([])
