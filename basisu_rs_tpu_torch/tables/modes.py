"""Static per-mode configuration for the 19 UASTC modes.

Numbers follow the UASTC spec as realized in the reference implementation
(reference: src/uastc.rs:528-557 MODES table).  Everything here is Python-level
static data: the transcode kernels are *specialized per mode* (`template <int
MODE>` over the traits that gen_header.py writes), so every field below turns
into compile-time constants (bit offsets, loop trip counts) rather than
device-side control flow.

The port's own copy of `basisu_rs_tpu/tables/modes.py`, held equal to it by
tests/test_torch_tables.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

RGB, RGBA, LA = 0, 1, 2

# Common-partition counts (reference: src/uastc.rs:742-744)
TOTAL_ASTC_BC7_COMMON_PARTITIONS2 = 30
TOTAL_ASTC_BC7_COMMON_PARTITIONS3 = 11
TOTAL_BC7_3_ASTC2_COMMON_PARTITIONS = 19

UASTC_BLOCK_SIZE = 16
ASTC_BLOCK_SIZE = 16
BC7_BLOCK_SIZE = 16
ETC1_BLOCK_SIZE = 8
ETC2_BLOCK_SIZE = 16


@dataclass(frozen=True)
class ModeCfg:
    id: int
    code_size: int
    endpoint_range_index: int
    format: int  # RGB / RGBA / LA
    weight_bits: int
    plane_count: int
    subset_count: int
    trans_flags_bits: int

    @property
    def has_alpha(self) -> bool:
        return self.format in (RGBA, LA)

    @property
    def has_blue(self) -> bool:
        return self.format in (RGB, RGBA)

    @property
    def channel_count(self) -> int:
        return {RGB: 3, RGBA: 4, LA: 2}[self.format]

    @property
    def endpoint_count(self) -> int:
        return self.channel_count * self.subset_count * 2

    @property
    def weight_count(self) -> int:
        return self.plane_count * 16

    @cached_property
    def pattern_bits(self) -> int:
        """Bits used by the pattern index field (reference: uastc.rs:352-366)."""
        if self.id == 7:
            return 5
        if self.subset_count == 1:
            return 0
        return 5 if self.subset_count == 2 else 4

    @cached_property
    def pattern_count(self) -> int:
        if self.id == 7:
            return TOTAL_BC7_3_ASTC2_COMMON_PARTITIONS
        if self.subset_count == 1:
            return 1
        if self.subset_count == 2:
            return TOTAL_ASTC_BC7_COMMON_PARTITIONS2
        return TOTAL_ASTC_BC7_COMMON_PARTITIONS3

    @cached_property
    def compsel_bits(self) -> int:
        """Dual-plane non-LA modes carry a 2-bit component selector
        (reference: uastc.rs:343-350)."""
        return 2 if (self.plane_count == 2 and self.format != LA) else 0

    # ---- static bit layout --------------------------------------------------

    @cached_property
    def field_offsets(self) -> dict:
        """Static bit offsets of every field in a (non-mode-8) block."""
        ofs = self.code_size
        out = {"trans_flags": ofs}
        ofs += self.trans_flags_bits
        out["compsel"] = ofs
        ofs += self.compsel_bits
        out["pattern"] = ofs
        ofs += self.pattern_bits
        out["endpoints"] = ofs
        out["weights"] = ofs + self.endpoint_bits
        return out

    @cached_property
    def endpoint_bits(self) -> int:
        from .bise import BISE_RANGES

        rng = BISE_RANGES[self.endpoint_range_index]
        e = self.endpoint_count
        total = 0
        if rng.quints:
            total += (e // 3) * 7 + {0: 0, 1: 3, 2: 5}[e % 3]
        if rng.trits:
            total += (e // 5) * 8 + {0: 0, 1: 2, 2: 4, 3: 5, 4: 7}[e % 5]
        total += e * rng.bits
        return total


# reference: src/uastc.rs:528-557
_M = ModeCfg
MODES: tuple[ModeCfg, ...] = (
    _M(0, 4, 19, RGB, 4, 1, 1, 15),
    _M(1, 6, 20, RGB, 2, 1, 1, 15),
    _M(2, 5, 8, RGB, 3, 1, 2, 15),
    _M(3, 5, 7, RGB, 2, 1, 3, 15),
    _M(4, 5, 12, RGB, 2, 1, 2, 15),
    _M(5, 5, 20, RGB, 3, 1, 1, 15),
    _M(6, 5, 18, RGB, 2, 2, 1, 15),
    _M(7, 5, 12, RGB, 2, 1, 2, 15),
    _M(8, 5, 0, RGBA, 0, 1, 1, 0),  # void-extent
    _M(9, 5, 8, RGBA, 2, 1, 2, 23),
    _M(10, 3, 13, RGBA, 4, 1, 1, 17),
    _M(11, 2, 13, RGBA, 2, 2, 1, 17),
    _M(12, 3, 19, RGBA, 3, 1, 1, 17),
    _M(13, 5, 20, RGBA, 1, 2, 1, 23),
    _M(14, 5, 20, RGBA, 2, 1, 1, 23),
    _M(15, 7, 20, LA, 4, 1, 1, 23),
    _M(16, 6, 20, LA, 2, 1, 2, 23),
    _M(17, 6, 20, LA, 2, 2, 1, 23),
    _M(18, 4, 11, RGB, 5, 1, 1, 15),
)

# Mode-8 (void extent) field offsets: 5-bit mode code, 32-bit RGBA, then the
# ETC1 hint flags (reference: uastc.rs:387-409).
MODE8_RGBA_OFFSET = 5
MODE8_ETC1_FLAGS_OFFSET = 37  # etc1d:1, etc1i:3, etc1s:2, etc1r:5, etc1g:5, etc1b:5
