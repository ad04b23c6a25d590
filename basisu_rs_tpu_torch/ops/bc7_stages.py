"""T1: the stage-ablation kernels of K1, plain versions and the wrapper.

Port of the stage closures of `tools/ablate_bc7.py:126-190`, the TPU tool
that times one stage of K1 for one UASTC mode through its own Pallas
kernel (`build_stage_kernel`, pl.pallas_call at :58).  A stage is
`stage(cfg, lanes) -> uint32 checksum a block`, the XOR of what it computes,
written here over the port's plain helpers (`uastc_decode.py`, `bc7.py`,
`bits.py`); the CUDA kernels are `bc7_stage_kernel<M, S>` in
`csrc/uastc_bc7_stages.cu` over K1's own device functions.

  full              K1's four output words and its err flag
  decode_endpoints  the unquantized endpoints
  decode_weights    the raw weights and the anchor texel indices
  decode_fields     endpoints, weights, component selector and pattern
  pbit              the unique-p-bit search (4 channels, 5 colour bits) on
                    fake endpoints taken from static extracts (the bytes of
                    words 0 and 1), once per UASTC subset; for 2-subset modes
                    the same result is XORed twice and the checksum is 0, in
                    both packages, so those launches time no search
  permute_invert    decode_fields, then the tool's own permutation, anchor
                    and invert arithmetic: the BC7 pattern index, each BC7
                    subset's permuted endpoints (swapped where its anchor
                    weight's bit 3 is set) and every weight remapped to 4
                    bits (inverted in the swapped subsets).  It is not K1's
                    invert step: subset 0 is tested too (at texel 0), mode 2's
                    weights are remapped to 4 bits, and nsub7 is the UASTC
                    subset count

Instantiated (mode, stage) pairs, `STAGE_MODES`: the pairs for which the
JAX stage functions trace.  full, decode_endpoints and pbit trace for every
mode 0-18; decode_weights and decode_fields for every mode but 8 (the void
extent has no weights; `decode_fields` asserts it); permute_invert for the
seven modes with a pattern family, 1, 2, 3, 4, 7, 9 and 16 (the others have
no family, or mode 8 no weights, or mode 13 1-bit weights that have no
4-bit remap): 100 kernels in all.  The tool's closure calls
`bc7._dyn_select`, a four-line helper that the JAX package has since
dropped; `_dyn_select` below restates it, and the tests trace the closure
with the same restatement.  The CUDA side states the same rule once, as
`kStageExists` in `csrc/uastc_bc7_stages.cuh`;
`tests/test_torch_csrc_host.py` holds the two equal for every (mode, stage).

`stage_kernel(mode, stage)(blocks)` is the wrapper: a tensor on the CPU
goes to the plain version (`PLAIN`), a CUDA tensor to the kernel, or the call
raises.  Checksums come back as int32 [N] (the uint32 bits).  Each wrapper
counts its launches and its plain-version calls.
"""

from __future__ import annotations

import torch

from ..tables import MODES, device_tables, get_family
from . import bc7, build
from .bits import M32, extract, lanes_from_bytes
from .uastc_decode import (assemble_endpoint_pairs, decode_endpoints, decode_fields, decode_pattern,
                           decode_weights, fam_row)

STAGES = build.BC7_STAGES  # index = the kernels' S
STAGE_MODES = {
    s: tuple(m for m in range(19) if not (m == 8 and s in ("decode_weights", "decode_fields"))) for s in STAGES
}
STAGE_MODES["permute_invert"] = (1, 2, 3, 4, 7, 9, 16)  # the modes with a pattern family


def _xor_all(values):
    acc = values[0]
    for v in values[1:]:
        acc = acc ^ v
    return acc


def _full(cfg, lanes, tables):
    words, err = bc7.uastc_to_bc7_mode(cfg, lanes)
    return _xor_all(words) ^ err.to(torch.int64)


def _decode_endpoints(cfg, lanes, tables):
    return _xor_all(decode_endpoints(cfg, lanes, tables)[2])


def _decode_weights(cfg, lanes, tables):
    pat, _ = decode_pattern(cfg, lanes)
    w, anchors = decode_weights(cfg, lanes, pat, tables)
    return _xor_all(w) ^ _xor_all(anchors)


def _decode_fields(cfg, lanes, tables):
    f = decode_fields(cfg, lanes, tables)
    return _xor_all(f.endpoints) ^ _xor_all(f.weights) ^ f.compsel ^ f.pat


def _pbit(cfg, lanes, tables):
    e_lo = [extract(lanes, 8 * c, 8) for c in range(4)]
    e_hi = [extract(lanes, 32 + 8 * c, 8) for c in range(4)]
    acc = None
    for _ in range(cfg.subset_count):
        lo, hi, p0, p1 = bc7.determine_unique_pbits(4, 5, e_lo, e_hi)
        v = _xor_all(lo) ^ _xor_all(hi) ^ p0 ^ p1
        acc = v if acc is None else acc ^ v
    return acc


def _dyn_select(values, idx):
    """values[idx] elementwise, values[0] where idx matches no index."""
    out = values[0]
    for k in range(1, len(values)):
        out = torch.where(idx == k, values[k], out)
    return out


def _permute_invert(cfg, lanes, tables):
    f = decode_fields(cfg, lanes, tables)
    pairs = assemble_endpoint_pairs(cfg, f.endpoints)
    w = [bc7.remap_weight_to_bc7(f.weights[i], cfg.weight_bits, 4) for i in range(16)]
    row = fam_row(get_family(cfg).name, f.pat)
    nsub7 = cfg.subset_count
    pat_packed = tables["FAM_BC7_PAT_PACKED"][row]
    anch_packed = tables["FAM_BC7_ANCHORS_PACKED"][row]
    perm_packed = tables["FAM_PERM_PACKED"][row]
    anchors = [torch.zeros_like(f.pat)] + [(anch_packed >> (4 * k)) & 15 for k in range(1, nsub7)]
    inv = [((_dyn_select(w, anchors[s]) >> 3) & 1).to(torch.bool) for s in range(nsub7)]
    acc = tables["FAM_BC7_INDEX"][row]
    for j in range(nsub7):
        pj = (perm_packed >> (4 * j)) & 15
        for c in range(4):
            lo = _dyn_select([pairs[s][0][c] for s in range(nsub7)], pj)
            hi = _dyn_select([pairs[s][1][c] for s in range(nsub7)], pj)
            acc = acc ^ torch.where(inv[j], hi, lo)
    for i in range(16):
        inv_i = _dyn_select(inv, (pat_packed >> (2 * i)) & 3)
        acc = acc ^ torch.where(inv_i, (~w[i]) & 15, w[i])
    return acc


_STAGE_FNS = {
    "full": _full,
    "decode_endpoints": _decode_endpoints,
    "decode_weights": _decode_weights,
    "decode_fields": _decode_fields,
    "pbit": _pbit,
    "permute_invert": _permute_invert,
}


def stage_rows(mode: int, stage: str, blocks, out) -> None:
    """Plain version of one T1 launch: the stage's checksum of every row of
    blocks (uint8 [N, 16]) into out (int32 [N], the uint32 bits)."""
    lanes = lanes_from_bytes(blocks, 4)
    words = _STAGE_FNS[stage](MODES[mode], lanes, device_tables(blocks.device)) & M32
    out.copy_(words.to(torch.int32))  # int64 0..2^32-1 -> the same 32 bits


class StageKernel:
    """UASTC mode `mode`, stage `stage`: one launch of bc7_stage_kernel<M, S>."""

    def __init__(self, mode: int, stage: str):
        self.mode = mode
        self.stage = stage
        self.stage_id = STAGES.index(stage)
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, blocks, out=None):
        """blocks: contiguous uint8 [N, 16] UASTC blocks, all of this mode.
        Returns out, int32 [N] checksums, allocated (torch.empty) when not
        given."""
        dev = blocks.device
        if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != 16 or not blocks.is_contiguous():
            raise ValueError(f"blocks must be contiguous uint8 [N, 16], got {blocks.dtype} {tuple(blocks.shape)}")
        n = blocks.shape[0]
        if out is None:
            out = torch.empty(n, dtype=torch.int32, device=dev)
        if out.dtype != torch.int32 or out.shape != (n,) or out.device != dev or not out.is_contiguous():
            raise ValueError("out must be a contiguous int32 [N] tensor on the blocks' device")
        if n == 0:
            return out
        if dev.type == "cpu":
            self.plain_calls += 1
            stage_rows(self.mode, self.stage, blocks, out)
        elif dev.type == "cuda":
            self._launch(blocks, n, out)
        else:
            raise ValueError(f"no stage kernel for device {dev}")
        return out

    def _launch(self, blocks, n, out) -> None:
        if n >= 2**31:
            raise ValueError(f"{n} blocks exceed one launch (2^31 - 1)")
        if blocks.data_ptr() % 16:
            raise ValueError("blocks must be 16-byte aligned")
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            rc = build.load().bc7_stage_launch(self.mode, self.stage_id, blocks.data_ptr(), n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"stage {self.stage} kernel of mode {self.mode}: launch failed, cudaError_t {rc}")
        self.launches += 1


_KERNELS = {(m, s): StageKernel(m, s) for s in STAGES for m in STAGE_MODES[s]}


def stage_kernel(mode: int, stage: str) -> StageKernel:
    if (mode, stage) not in _KERNELS:
        raise ValueError(f"no {stage} stage kernel for mode {mode}: the JAX stage function does not trace for it")
    return _KERNELS[(mode, stage)]


def launch_counts() -> dict:
    """{(mode, stage): launches}"""
    return {k: w.launches for k, w in _KERNELS.items()}


def plain_call_counts() -> dict:
    return {k: w.plain_calls for k, w in _KERNELS.items()}


def reset_counts() -> None:
    for w in _KERNELS.values():
        w.launches = 0
        w.plain_calls = 0
