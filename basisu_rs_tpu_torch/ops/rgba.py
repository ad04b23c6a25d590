"""UASTC -> RGBA32 unpack per mode: the plain PyTorch version of K3.

Port of `basisu_rs_tpu/ops/rgba.py` (`uastc_to_rgba_channels`,
`uastc_to_rgba_mode`, `pack_rgba`), mirroring `decode_block_to_rgba`
(reference: src/uastc.rs:237-327): decode the mode's fields, unquantize
endpoints and weights, then the fixed-point ASTC lerp per texel and channel
with single/dual-plane routing and the multi-subset pattern lookup.  Texels
are packed little-endian RGBA words (Color32::to_rgba_u32, src/color.rs:22-24).

This is the function the CUDA kernel (`csrc/uastc_rgba.cuh`) is held against:
the CPU tests use it, and `chip_smoke.py` compares the kernel with it on the
card.  The kernel wrapper (`ops/kernels.py`) reaches it only for tensors on
the CPU.
"""

from __future__ import annotations

import torch

from ..tables import LA, MODES, ModeCfg, device_tables
from .bits import apply_rows, lane_shape
from .uastc_decode import (
    assemble_endpoint_pairs,
    decode_fields,
    decode_mode8_rgba,
    interp_eval,
    interp_hoist,
    subsets_for_texels,
    unquant_weight,
)


def pack_rgba(r, g, b, a):
    return r | (g << 8) | (b << 16) | (a << 24)


def uastc_to_rgba_channels(cfg: ModeCfg, lanes, need_alpha: bool = True):
    """Returns (texels, err): texels = list of 16 per-texel [r, g, b, a]
    int64 [N] values in 0..255.  need_alpha=False skips the alpha channel
    (slot 3 holds None): the ETC1 target never reads it."""
    if cfg.id == 8:
        rgba = decode_mode8_rgba(lanes)
        return [rgba] * 16, torch.zeros(lane_shape(lanes), dtype=torch.bool, device=lanes.device)

    tables = device_tables(lanes.device)
    f = decode_fields(cfg, lanes, tables)
    wq = [unquant_weight(w, cfg.weight_bits) for w in f.weights]
    pairs = assemble_endpoint_pairs(cfg, f.endpoints)
    nsub = cfg.subset_count
    nch = 4 if need_alpha else 3

    # A channel whose endpoints are one shared tensor (RGB alpha, 255) is
    # constant: the lerp of equal endpoints is the identity.
    const = [all(pairs[s][k][c] is pairs[0][0][c] for s in range(nsub) for k in (0, 1)) for c in range(nch)]
    # (L0, D) halves of the factored lerp, once per subset and channel
    hoisted = [[interp_hoist(pairs[s][0][c], pairs[s][1][c]) for c in range(nch)] for s in range(nsub)]
    pad = [] if need_alpha else [None]

    texels = []
    if nsub == 1:
        if cfg.plane_count == 1:
            plane_w = [[wq[i]] * 4 for i in range(16)]
        elif cfg.format == LA:
            # LA dual plane selects alpha statically (uastc.rs:343-350)
            plane_w = [[wq[2 * i]] * 3 + [wq[2 * i + 1]] for i in range(16)]
        else:
            sel = [f.compsel == c for c in range(4)]
            plane_w = [[torch.where(sel[c], wq[2 * i + 1], wq[2 * i]) for c in range(4)] for i in range(16)]
        for i in range(16):
            texels.append([
                pairs[0][0][c] if const[c] else interp_eval(*hoisted[0][c], plane_w[i][c])
                for c in range(nch)
            ] + pad)
    else:
        subsets = subsets_for_texels(cfg, f.pat, tables)
        for i in range(16):
            s_mask = [subsets[i] == s for s in range(1, nsub)]
            px = []
            for c in range(nch):
                if const[c]:
                    px.append(pairs[0][0][c])
                    continue
                L0, D = hoisted[0][c]
                for s in range(1, nsub):
                    L0 = torch.where(s_mask[s - 1], hoisted[s][c][0], L0)
                    D = torch.where(s_mask[s - 1], hoisted[s][c][1], D)
                px.append(interp_eval(L0, D, wq[i]))
            texels.append(px + pad)
    return texels, f.err


def uastc_to_rgba_mode(cfg: ModeCfg, lanes):
    """int64 [N,4] UASTC words -> (list of 16 packed RGBA texel words, err bool[N])."""
    texels, err = uastc_to_rgba_channels(cfg, lanes)
    return [pack_rgba(*px) for px in texels], err


def transcode_rows(mode: int, blocks, index, out, err) -> None:
    """Plain version of one K3 launch: unpack blocks[index] (all UASTC mode
    `mode`) into the uint8 [N,64] rows out[index] and err[index], in place.
    index=None means every row."""
    apply_rows(lambda lanes: uastc_to_rgba_mode(MODES[mode], lanes), blocks, index, out, err)
