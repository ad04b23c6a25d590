"""Multi-device sharding: data-parallel block transcode over a list of
devices.

Port of `basisu_rs_tpu/parallel/mesh.py`.  The work is data-parallel
(blocks and slices are independent; the math needs no collective), so a
mesh is a 1-D tuple of torch devices and inputs split contiguously over
the block axis, shard k taking rows [k * per, (k + 1) * per) with per =
ceil(N / len(mesh)) (`base.shard_bounds`), the rows JAX's padded
block-axis sharding gives each device.  The only cross-device traffic is
each shard's output copied into place on mesh[0] and, for the step
functions, error counts summed on the host.

This module names the devices (`make_mesh`, `mesh_devices`,
`resolve_mesh`), splits the inputs (`shard_blocks`) and opens the
`parallel.*` root spans; the work over the shards is the one
implementation the one-device entries run too:

  - `sharded_transcode` (production): `ops/dispatch.py` `transcode_shards`,
    for BC7 one tile-kernel launch a shard, for the other targets each
    shard's mode partition and one launch per present mode, on its device.
  - `sharded_transcode_step`: the contract of the JAX step (padded shards
    in, outputs and a global error count out), computed by the same
    `transcode_shards`; the JAX package's all-modes graph exists only for
    `jit` and is not ported.
  - `sharded_mode_step`: one unindexed launch of one mode's kernel a shard.
  - `sharded_etc1s_transcode`: `ops/etc1s.py` `run_etc1s`, the codebooks
    copied to every device, the index streams split, one K6-K9 launch a
    shard.

Each shard runs where its device is: the wrappers of `ops/kernels.py` and
`ops/etc1s.py` launch the hand-written kernel on a CUDA tensor and run the
plain version on a CPU tensor, so the JAX package's `mesh_backend` has no
counterpart.  Shards on mesh[0] write straight into views of the result,
whose row offsets keep every output row aligned as the kernels require
(16-byte block rows, output rows of 8, 16 or 64 bytes).  A one-device
mesh is the single-device path: one copy from the host, the same
launches (the file readers of `container/basis.py` always run
through here).
"""

from __future__ import annotations

import warnings

import torch

from ..base import block_tensor, resolve_device, run_shard, shard_bounds, to_device
from ..ops.dispatch import check_target, transcode_shards
from ..ops.etc1s import KINDS, run_etc1s
from ..ops.kernels import OUT_BYTES, mode_kernel
from ..utils.profiling import count, span


def make_mesh(n_devices: int | None = None, *, allow_cpu_fallback: bool = False) -> tuple:
    """The first n_devices CUDA devices (all of them if None), as a tuple of
    torch.device with explicit indices.

    When fewer CUDA devices exist than asked for, this RAISES rather than
    silently running on the CPU, which is orders of magnitude slower than
    the cards the caller asked for.  Dry runs that really want CPU
    "devices" opt in with allow_cpu_fallback=True, which still warns
    loudly and returns n_devices entries of torch.device("cpu") (one with
    no card and n_devices None).  Unlike the JAX package's virtual CPU
    devices, these are one device named n times, so any count is granted."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n == 0 or count < n:
        if not allow_cpu_fallback:
            what = f"a {n_devices}-device mesh" if n_devices else "a mesh of every CUDA device"
            raise ValueError(
                f"requested {what} but CUDA has {count} device(s); for a sharding dry run on CPU "
                "devices pass allow_cpu_fallback=True"
            )
        n = n or 1
        warnings.warn(
            f"make_mesh: CUDA has only {count} device(s); falling back to {n} CPU devices "
            "(dry-run performance, not card performance)",
            stacklevel=2,
        )
        return (torch.device("cpu"),) * n
    return tuple(torch.device("cuda", i) for i in range(n))


def mesh_devices(mesh) -> tuple:
    """A mesh (any sequence of devices or device names) as torch devices
    with explicit indices: the device tables are cached per torch.device,
    and torch.device("cuda") is another key than torch.device("cuda", 0)."""
    devices = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devices.append(d)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(devices)


def resolve_mesh(device, mesh=None) -> tuple:
    """The mesh an entry point runs on: mesh_devices(mesh), or the one
    device `device` names (resolve_device: "cuda" needs a card) when mesh
    is None."""
    return mesh_devices(mesh) if mesh is not None else (resolve_device(device),)


def _shards(t: torch.Tensor, devices) -> list:
    """t's contiguous row shards, each copied from where t lies to its
    device (a view where that is t's own device)."""
    return [to_device(t[a:b], d) for d, (a, b) in zip(devices, shard_bounds(t.shape[0], len(devices)))]


def shard_blocks(blocks, mesh) -> list:
    """uint8 [N,16] blocks (numpy or torch) -> the per-device uint8
    [N/len(mesh), 16] shards, N padded with zero blocks to a multiple of
    the mesh size as the JAX package pads it; each shard is copied from
    where the blocks lie straight to its device."""
    devices = mesh_devices(mesh)
    t = block_tensor(blocks)
    pad = (-t.shape[0]) % len(devices)
    if pad:
        t = torch.cat([t, torch.zeros(pad, 16, dtype=torch.uint8, device=t.device)])
    return _shards(t, devices)


def sharded_transcode(blocks, target: str, mesh) -> tuple:
    """Production multi-device batch transcode: uint8 [N,16] blocks (numpy
    or torch) -> (out, err) on mesh[0], in block order, with the dtypes and
    shapes of ops.dispatch.transcode_blocks.  The block axis splits
    contiguously over the mesh; each shard is copied from where the blocks
    lie straight to its device and is transcoded there
    (`transcode_shards`).  Span: `parallel.transcode`."""
    with span("parallel.transcode"):
        devices = mesh_devices(mesh)
        return transcode_shards(_shards(block_tensor(blocks), devices), target, devices[0])


def sharded_transcode_step(target: str, mesh):
    """The multi-device transcode step: a callable taking shard_blocks()'
    list (one shard a device) and returning (out on mesh[0] in block order,
    global error count as a host int).  Pad rows count as they transcode,
    as in the JAX step."""
    devices = mesh_devices(mesh)

    def step(shards):
        if len(shards) != len(devices):
            raise ValueError(f"expected {len(devices)} shards, got {len(shards)}")
        with span("parallel.transcode"):
            out, err = transcode_shards(list(shards), target, devices[0])
            count("host_syncs")
            return out, int(err.sum())

    return step


def sharded_mode_step(target: str, mode_id: int, mesh):
    """The multi-device single-mode step: a callable taking uint8 [N,16]
    blocks (numpy or torch), all of mode `mode_id`, and returning (out on
    mesh[0] as uint8 [N, OUT_BYTES[target]], err bool [N], global error
    count as a host int).  Each shard is one contiguous, unindexed launch
    of that mode's kernel on its device."""
    check_target(target)
    devices = mesh_devices(mesh)
    kernel = mode_kernel(target, mode_id)

    def step(blocks):
        with span("parallel.mode"):
            t = block_tensor(blocks)
            n = t.shape[0]
            out = torch.empty(n, OUT_BYTES[target], dtype=torch.uint8, device=devices[0])
            err = torch.empty(n, dtype=torch.bool, device=devices[0])
            for d, shard, (a, b) in zip(devices, _shards(t, devices), shard_bounds(n, len(devices))):
                run_shard(d, (out[a:b], err[a:b]), lambda o, e, shard=shard: kernel(shard, None, o, e))
            count("host_syncs")
            return out, err, int(err.sum())

    return step


def sharded_etc1s_transcode(kind: str, endpoints, selectors, ep_idx, sel_idx, mesh, extra_idx=(),
                            check_index: bool = True) -> torch.Tensor:
    """Multi-device ETC1S back-end: the codebooks (shared by every block of
    a file) are copied to every device, the per-block index streams split
    contiguously over the mesh, one K6-K9 launch a shard.

    kind: "rgba" (K6), "alpha" (K7), "etc1" (K9), or "rgba_alpha" (K8, the
    fused RGB + alpha slice pair: pass the alpha slice's index streams as
    extra_idx=(a_ep_idx, a_sel_idx)).  endpoints: uint8 [E, 4]; selectors:
    uint8 [S, 4] row bytes; index streams numpy or torch.  Every index is
    checked against its codebook unless check_index is False (a caller that
    already checked them, as the file path's front-end does).  Returns the
    uint32 view of the rows on mesh[0] in block order: [N, 16] for the
    texel kinds, [N, 2] for "etc1", the JAX function's shapes.  Spans:
    `parallel.etc1s`, and ops.etc1s.run_etc1s'."""
    if kind not in KINDS:
        raise ValueError(f"unknown ETC1S kind {kind!r}; one of {', '.join(KINDS)}")
    with span("parallel.etc1s"):
        return run_etc1s(kind, endpoints, selectors, (ep_idx, sel_idx, *extra_idx), mesh_devices(mesh), check_index)
