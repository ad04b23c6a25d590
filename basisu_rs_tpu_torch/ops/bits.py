"""Bit-field access over batches of 128-bit blocks, in PyTorch.

Port of `basisu_rs_tpu/ops/bits.py`.  A batch of N blocks is an int64
`[N, W]` tensor of little-endian 32-bit words, each word held as a value in
0..2^32-1.  Words are int64 rather than int32 because torch's `>>` on a
signed type is arithmetic while the reference's uint32 shift is logical; in
int64 every word is non-negative, so `>>` is logical, and every left shift
is masked back to 32 bits.  Constant tables are indexed directly
(`table[idx]`): `lut_lookup` and the tuple-of-planes lane form exist in the
JAX package only for its Pallas kernels.

Semantics match the reference bit-exactly:
  - reads past the end of the block return zero bits
  - writes past the end are dropped
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mask(count: int) -> int:
    return (1 << count) - 1


def lane_shape(lanes):
    return lanes.shape[:-1]


def lane_count(lanes) -> int:
    return lanes.shape[-1]


def lane(lanes, w: int):
    return lanes[..., w]


def _zeros(lanes):
    return torch.zeros(lane_shape(lanes), dtype=torch.int64, device=lanes.device)


def lanes_from_bytes(blocks_u8: torch.Tensor, word_count: int) -> torch.Tensor:
    """uint8 [N, word_count*4] -> int64 [N, word_count] little-endian words."""
    b = blocks_u8.reshape(-1, word_count, 4).to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def bytes_from_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """int64 [N, W] words -> uint8 [N, W*4]."""
    out = torch.stack([(lanes >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return out.to(torch.uint8).reshape(lanes.shape[0], 4 * lanes.shape[1])


def apply_rows(fn, blocks, index, out, err) -> None:
    """Plain version of one per-mode kernel launch: fn(int64 [M,4] words) ->
    (output words, err) over blocks[index] (every row when index is None),
    written into the uint8 rows out[index] and err[index] in place."""
    rows = blocks if index is None else blocks[index]
    words, e = fn(lanes_from_bytes(rows, 4))
    res = bytes_from_lanes(torch.stack(words, dim=-1))
    if index is None:
        out.copy_(res)
        err.copy_(e)
    else:
        out[index] = res
        err[index] = e


def extract(lanes, offset: int, count: int):
    """Static-offset extract of `count` bits at `offset`."""
    assert 0 <= count <= 32
    if count == 0:
        return _zeros(lanes)
    W = lane_count(lanes)
    w, b = offset // 32, offset % 32
    lo = lane(lanes, w) if w < W else _zeros(lanes)
    val = lo >> b
    if b + count > 32 and w + 1 < W:
        val = val | (lane(lanes, w + 1) << (32 - b))
    return val & mask(count)


def _word_select(lanes, w, lo_word: int, hi_word: int, default):
    """lanes[w] for a dynamic word index w in [lo_word, hi_word]."""
    out = default
    for k in range(lo_word, hi_word + 1):
        out = torch.where(w == k, lane(lanes, k), out)
    return out


def extract_dyn(lanes, offset, count: int, bit_range=None):
    """Dynamic-offset extract; `offset` is an integer tensor broadcastable
    to the batch.  bit_range=(lo, hi): static bounds on the offset."""
    assert 0 < count <= 32
    W = lane_count(lanes)
    if bit_range is not None:
        wlo = max(bit_range[0] // 32, 0)
        whi = min((bit_range[1] + count - 1) // 32, W - 1)
    else:
        wlo, whi = 0, W - 1
    offset = offset.to(torch.int64)
    w = offset >> 5
    b = offset & 31
    zero = torch.zeros_like(w).expand(torch.broadcast_shapes(lane_shape(lanes), w.shape))
    if wlo == whi:
        lo = lane(lanes, wlo)
        hi = lane(lanes, wlo + 1) if wlo + 1 < W else zero
    else:
        lo = _word_select(lanes, w, wlo, min(whi, W - 1), zero)
        hi = zero
        for k in range(wlo + 1, min(whi + 2, W)):
            hi = torch.where(w == k - 1, lane(lanes, k), hi)
    # b == 0 would shift hi by 32: the reference's guard zeroes that term
    hi_part = torch.where(b == 0, 0, (hi << ((32 - b) & 31)) & M32)
    return ((lo >> b) | hi_part) & mask(count)


def extract_bit_dyn(lanes, offset, bit_range):
    """Single dynamic bit as int64 0/1 (never straddles a word)."""
    wlo, whi = bit_range[0] // 32, (bit_range[1] - 1) // 32
    offset = offset.to(torch.int64)
    v = lane(lanes, wlo)
    if whi > wlo:
        v = _word_select(lanes, offset >> 5, wlo + 1, whi, v)
    return (v >> (offset & 31)) & 1


class LaneWriter:
    """OR-accumulates bit fields into W 32-bit output words (int64 tensors).

    Constant bits accumulate in a Python int per word (`put_const`) and are
    folded in when `.lanes` is read."""

    def __init__(self, shape, word_count: int, device):
        self.W = word_count
        self.shape = shape
        self.device = device
        self._lanes = [None] * word_count
        self._const = [0] * word_count

    @property
    def lanes(self):
        out = []
        for l, c in zip(self._lanes, self._const):
            if l is None:
                out.append(torch.full(self.shape, c, dtype=torch.int64, device=self.device))
            else:
                out.append(l | c if c else l)
        return out

    def _or(self, w: int, expr) -> None:
        self._lanes[w] = expr if self._lanes[w] is None else self._lanes[w] | expr

    def put(self, value, offset: int, count: int) -> None:
        if count == 0:
            return
        assert count <= 32
        value = value.to(torch.int64) & mask(count)
        w, b = offset // 32, offset % 32
        if w < self.W:
            self._or(w, (value << b) & M32)
        if b + count > 32 and w + 1 < self.W:
            self._or(w + 1, value >> (32 - b))

    def put_const(self, value: int, offset: int, count: int) -> None:
        if count == 0:
            return
        assert count <= 32
        value &= mask(count)
        w, b = offset // 32, offset % 32
        if w < self.W:
            self._const[w] |= (value << b) & M32
        if b + count > 32 and w + 1 < self.W:
            self._const[w + 1] |= value >> (32 - b)

    def put_dyn(self, value, offset, count: int, bit_range=None) -> None:
        """bit_range=(lo, hi): static bounds on `offset` (see extract_dyn)."""
        assert 0 < count <= 32
        if bit_range is not None:
            wlo = max(bit_range[0] // 32, 0)
            whi = min((bit_range[1] + count - 1) // 32, self.W - 1)
        else:
            wlo, whi = 0, self.W - 1
        value = value.to(torch.int64) & mask(count)
        offset = offset.to(torch.int64)
        w = offset >> 5
        b = offset & 31
        lo = (value << b) & M32
        # b == 0: the high part is empty (a 32-bit shift in the reference)
        hi = torch.where(b == 0, 0, value >> ((32 - b) & 31))
        if wlo == whi:
            self._or(wlo, lo)
            if wlo + 1 < self.W:
                self._or(wlo + 1, hi)
            return
        for k in range(wlo, min(whi + 1, self.W)):
            self._or(k, torch.where(w == k, lo, 0))
        for k in range(wlo + 1, min(whi + 2, self.W)):
            self._or(k, torch.where(w == k - 1, hi, 0))

    def stack(self):
        return torch.stack(self.lanes, dim=-1)


def bitrev(value, count: int):
    """Reverse the low `count` bits of `value` (count static, <= 8)."""
    v = value
    if count == 1:
        return v & 1
    if count == 2:
        return ((v & 1) << 1) | ((v >> 1) & 1)
    if count == 3:
        return ((v & 1) << 2) | (v & 2) | ((v >> 2) & 1)
    if count == 4:
        return ((v & 1) << 3) | ((v & 2) << 1) | ((v >> 1) & 2) | ((v >> 3) & 1)
    if count == 5:
        return ((v & 1) << 4) | ((v & 2) << 2) | (v & 4) | ((v >> 2) & 2) | ((v >> 4) & 1)
    out = torch.zeros_like(value)
    for i in range(count):
        out = out | (((value >> i) & 1) << (count - 1 - i))
    return out


# fl(2^-16 / (1 - 2^-16)), IEEE single: the relative correction that turns
# x*257*2^-16 = x*257/65536 into x*257/65535 = x/255.
DIV255_K = float.fromhex("0x1.0001p-16")
DIV255_Y0 = 257.0 * 2.0**-16


def fl_div255(x):
    """IEEE-single fl(x/255) for integer tensors x in 0..255, division-free:
    y0 = x * 257*2^-16 is exact, and fl(x/255) = fl(y0 + fl(y0*K)).

    Each eager torch op rounds once, so the multiply and the add round
    separately, as the reference requires (no addcmul, no torch.compile)."""
    y0 = x.to(torch.float32) * DIV255_Y0
    c = y0 * DIV255_K
    return y0 + c
