"""BC7 mode table and derived LUTs.

- BC7_MODES: the 8 BC7 block modes' parameters (reference:
  src/target_formats/bc7.rs:569-579).
- Optimal solid-color endpoint tables for BC7 modes 5/6, regenerated by the
  brute-force search the reference documents in its own LUT-validity tests
  (bc7.rs:1158-1250) rather than transcribed.

The port's own copy of the parts of `basisu_rs_tpu/tables/bc7_tables.py`
that it uses (its p-bit search computes fl(x/255) directly, so the f32
p-bit LUTs are not copied), held equal by tests/test_torch_tables.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class Bc7Mode:
    id: int
    pat_bits: int
    endpoint_count: int
    color_bits: int
    alpha_bits: int
    weight_bits: int
    plane_count: int
    subset_count: int
    p_bits: int
    sp_bits: int

    @property
    def channel_count(self) -> int:
        return self.endpoint_count // (2 * self.subset_count)


_B = Bc7Mode
BC7_MODES: tuple[Bc7Mode, ...] = (
    _B(0, 4, 18, 4, 0, 3, 1, 3, 1, 0),
    _B(1, 6, 12, 6, 0, 3, 1, 2, 0, 1),
    _B(2, 6, 18, 5, 0, 2, 1, 3, 0, 0),
    _B(3, 6, 12, 7, 0, 2, 1, 2, 1, 0),
    _B(4, 0, 8, 5, 6, 2, 2, 1, 0, 0),
    _B(5, 0, 8, 7, 8, 2, 2, 1, 0, 0),
    _B(6, 0, 8, 7, 7, 4, 1, 1, 1, 0),
    _B(7, 6, 16, 5, 5, 2, 1, 2, 1, 0),
)

BC7ENC_MODE_5_OPTIMAL_INDEX = 1
BC7ENC_MODE_6_OPTIMAL_INDEX = 5

_WEIGHTS2 = (0, 21, 43, 64)
_WEIGHTS4 = (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)


def _optimal_search(expand, weight: int) -> np.ndarray:
    """For each target byte c, the (lo, hi) 7-bit pair (lo<=hi, first minimal
    in (lo asc, hi asc) order) minimizing the interpolation error.  Mirrors
    the searches in the reference's LUT tests (bc7.rs:1158-1250)."""
    l, h = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    valid = h >= l
    ls, hs = l[valid], h[valid]  # ordered (l asc, then h asc) like the loops
    k = (expand(ls) * (64 - weight) + expand(hs) * weight + 32) >> 6
    err = (k[None, :] - np.arange(256)[:, None]) ** 2  # [256, pairs]
    best = np.argmin(err, axis=1)  # first minimum == loop order
    return np.stack([ls[best], hs[best]], axis=1).astype(np.uint8)  # [256, 2]


@lru_cache(maxsize=None)
def bc7_mode_5_optimal_endpoints() -> np.ndarray:
    """[256, 2] uint8: (lo, hi) per solid color byte, BC7 mode 5 (777)."""
    return _optimal_search(lambda v: (v << 1) | (v >> 6), _WEIGHTS2[BC7ENC_MODE_5_OPTIMAL_INDEX])


@lru_cache(maxsize=None)
def bc7_mode_6_optimal_endpoints() -> np.ndarray:
    """[257, 2] uint8, BC7 mode 6 (777.1): index c + (1 - p_bit), exploiting
    entry[c+1] @ p=0 == entry[c] @ p=1 (reference: bc7.rs:1126-1131)."""
    w = _WEIGHTS4[BC7ENC_MODE_6_OPTIMAL_INDEX]
    p0 = _optimal_search(lambda v: (v << 1) | 0, w)
    first = _optimal_search(lambda v: (v << 1) | 1, w)[0]  # c=0 at p=1
    return np.concatenate([first[None, :], p0], axis=0)


@lru_cache(maxsize=None)
def bc7_mode_5_optimal_packed() -> np.ndarray:
    """[256] int32: lo | hi << 7 - exactly the mode-5 emission bit layout
    (lo at +0, hi at +7), so ONE gather + ONE 14-bit deposit per channel
    replaces two of each, with zero unpack ops."""
    t = bc7_mode_5_optimal_endpoints().astype(np.int32)
    return t[:, 0] | (t[:, 1] << 7)


@lru_cache(maxsize=None)
def bc7_mode_6_optimal_packed() -> np.ndarray:
    """[257] int32: lo | hi << 7, mode-6 emission layout (see mode 5)."""
    t = bc7_mode_6_optimal_endpoints().astype(np.int32)
    return t[:, 0] | (t[:, 1] << 7)

