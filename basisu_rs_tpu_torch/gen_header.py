"""Generate `csrc/uastc_tables.cuh` from the port's numpy tables.

    python -m basisu_rs_tpu_torch.gen_header    # rewrite the header

The header carries every constant the BC7, ASTC, RGBA, ETC1 and ETC2
kernels need:
per-mode static configuration as `Mode<M>` / `Bc7Mode<B>` / `BiseRange<R>`
/ `Family<F>` traits (compile-time constants, so every bit offset folds),
and the
run-time-indexed tables of `tables.kernel_tables()` as flat arrays.  The
plain PyTorch version indexes the very same arrays (`tables.device_tables`),
and tests/test_torch_tables.py checks that the checked-in header equals a
fresh run of this generator.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .tables import (
    BC7_MODES,
    BISE_RANGES,
    FAMILIES,
    MODE8_ETC1_FLAGS_OFFSET,
    MODE8_RGBA_OFFSET,
    MODES,
    bc7_mode_of,
    np_tables,
    family_consts,
    family_name,
    inv_relpos_bounds,
    kernel_tables,
)

HEADER = Path(__file__).resolve().parent / "csrc" / "uastc_tables.cuh"

_CTYPE = {np.uint8: "uint8_t", np.uint16: "uint16_t", np.uint32: "uint32_t"}


def _traits(name: str, index: int, fields: dict) -> str:
    body = "\n".join(f"  static constexpr {t} {k} = {v};" for k, (t, v) in fields.items())
    return f"template <> struct {name}<{index}> {{\n{body}\n}};"


def _array(name: str, a: np.ndarray) -> str:
    ctype = _CTYPE[a.dtype.type]
    fmt = "{:#010x}" if a.dtype == np.uint32 else "{}"
    vals = [fmt.format(int(v)) for v in a]
    per = 8 if a.dtype == np.uint32 else 16
    lines = [", ".join(vals[i : i + per]) for i in range(0, len(vals), per)]
    body = ",\n  ".join(lines)
    return f"UB_TABLE {ctype} {name}[{len(a)}] = {{\n  {body}\n}};"


def _mode_fields(cfg) -> dict:
    layout = kernel_tables()[1]
    rng = BISE_RANGES[cfg.endpoint_range_index]
    ofs = cfg.field_offsets
    fam = family_name(cfg)
    bc7 = bc7_mode_of(cfg)
    inv_base, bounds = -1, [(0, 0), (0, 0)]
    if (fam, cfg.weight_bits) in layout.inv_relpos_base and cfg.id != 8:
        inv_base = layout.inv_relpos_base[(fam, cfg.weight_bits)]
        bounds = inv_relpos_bounds(fam, cfg.weight_bits)
    i = "int"
    return {
        "id": (i, cfg.id),
        "code_size": (i, cfg.code_size),
        "range": (i, cfg.endpoint_range_index),
        "format": (i, cfg.format),
        "weight_bits": (i, cfg.weight_bits),
        "planes": (i, cfg.plane_count),
        "subsets": (i, cfg.subset_count),
        "compsel_bits": (i, cfg.compsel_bits),
        "pattern_bits": (i, cfg.pattern_bits),
        "pattern_count": (i, cfg.pattern_count),
        "endpoint_count": (i, cfg.endpoint_count),
        "ofs_trans_flags": (i, ofs["trans_flags"]),
        "ofs_compsel": (i, ofs["compsel"]),
        "ofs_pattern": (i, ofs["pattern"]),
        "ofs_endpoints": (i, ofs["endpoints"]),
        "ofs_weights": (i, ofs["weights"]),
        "bc7": (i, bc7),
        "astc_block_mode": (i, int(np_tables()["UASTC_TO_ASTC_BLOCK_MODE_13"][cfg.id])),
        "fam": (i, FAMILIES.index(fam) if fam is not None else -1),
        "multi": ("bool", "true" if (cfg.subset_count > 1 or cfg.id == 7) else "false"),
        "inv_base": (i, inv_base),
        "inv_lo1": (i, bounds[0][0]),
        "inv_hi1": (i, bounds[0][1]),
        "inv_lo2": (i, bounds[1][0]),
        "inv_hi2": (i, bounds[1][1]),
    }


def render() -> str:
    arrays, layout = kernel_tables()
    i = "int"
    parts = [
        "// Generated by `python -m basisu_rs_tpu_torch.gen_header` from the numpy",
        "// tables in basisu_rs_tpu_torch/tables/. Do not edit by hand.",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "#ifndef UB_TABLE",
        '#error "include uastc_decode.cuh, which defines UB_TABLE"',
        "#endif",
        "",
        "namespace ub {",
        "",
        "constexpr int INVALID_MODE = 19;",
        "constexpr int FORMAT_RGB = 0, FORMAT_RGBA = 1, FORMAT_LA = 2;",
        f"constexpr int MODE8_RGBA_OFFSET = {MODE8_RGBA_OFFSET}, MODE8_ETC1_FLAGS_OFFSET = {MODE8_ETC1_FLAGS_OFFSET};",
        "constexpr int FAM_NONE = -1, "
        + ", ".join(f"FAM_{n.upper()} = {k}" for k, n in enumerate(FAMILIES))
        + ";",
        "",
        "// UASTC modes (ModeCfg + field offsets; bc7 = UASTC_TO_BC7_MODES[id],",
        "// astc_block_mode = UASTC_TO_ASTC_BLOCK_MODE_13[id]).",
        "template <int M> struct Mode;",
    ]
    parts += [_traits("Mode", cfg.id, _mode_fields(cfg)) for cfg in MODES]
    parts += ["", "// BC7_MODES.", "template <int B> struct Bc7Mode;"]
    for bm in BC7_MODES:
        fields = {
            k: (i, getattr(bm, k))
            for k in (
                "id", "pat_bits", "endpoint_count", "color_bits", "alpha_bits",
                "weight_bits", "plane_count", "subset_count", "p_bits", "sp_bits",
            )
        }
        fields["channels"] = (i, bm.channel_count)
        parts.append(_traits("Bc7Mode", bm.id, fields))
    parts += ["", "// BISE ranges; unquant_base indexes UNQUANT_LUT (-1: pure bits).",
              "template <int R> struct BiseRange;"]
    for r, rng in enumerate(BISE_RANGES):
        fields = {
            "bits": (i, rng.bits),
            "trits": (i, rng.trits),
            "quints": (i, rng.quints),
            "unquant_base": (i, layout.unquant_base.get(r, -1)),
        }
        parts.append(_traits("BiseRange", r, fields))
    parts += ["", "// Pattern families; base indexes every FAM_* table.",
              "template <int F> struct Family;"]
    for k, name in enumerate(FAMILIES):
        c = family_consts(name)
        fields = {key: (i if key in ("count", "n_anchors", "base") else "uint32_t",
                        c[key] if key in ("count", "n_anchors", "base") else f"{c[key]:#010x}u")
                  for key in c}
        parts.append(_traits("Family", k, fields))
    parts.append("")
    parts += [_array(name, a) for name, a in arrays.items()]
    parts += ["", "}  // namespace ub", ""]
    return "\n".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
