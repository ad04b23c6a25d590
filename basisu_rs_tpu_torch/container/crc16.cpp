// CRC-16/GENIBUS over a byte buffer (reference: src/basis.rs:364-372), the
// checksum of the .basis header and data.  The same value as basisu_crc16 in
// basisu_rs_tpu/native/etc1s.cpp; container/crc.py builds this file with g++
// at first use and holds it against a table-driven Python version.
//
// The CRC is non-reflected (MSB first) over P = x^16 + x^12 + x^5 + 1: with
// r = ~crc, the register after the n bits of message M is
//   r' = (r * x^n + M * x^16) mod P,
// so r can be XORed into the message's first 16 bits, and the message can be
// reduced mod P in any grouping before the final multiply by x^16.  Two paths
// compute it:
//   - table: slice-by-16 over a 16x256 table, T[j][q] = q * x^(16 + 8j) mod P,
//     16 bytes a step; every host, and buffers shorter than FOLD_MIN;
//   - fold (x86-64 with PCLMULQDQ): 4 independent 128-bit accumulators over
//     64-byte strides, each step a carry-less multiply by x^S mod P, loads
//     prefetched 4 KiB ahead, then the table path over the last accumulator
//     and the tail.
// basisu_crc16 picks the fold when the buffer has FOLD_MIN bytes or more and
// the CPU has PCLMULQDQ and SSSE3 (read once), and reports the bytes the fold
// consumed.  basisu_crc16_table and basisu_crc16_fold run one path each.
#include <stddef.h>
#include <stdint.h>

#if defined(__x86_64__)
#include <immintrin.h>
#define CRC16_HAS_FOLD 1
#else
#define CRC16_HAS_FOLD 0
#endif

namespace {

constexpr uint32_t POLY = 0x11021;  // x^16 + x^12 + x^5 + 1
// Below this many bytes the table path runs.  From here on the fold takes at
// most 60% of the table's time (32 vs 56 ns at 128 bytes, 91 vs 447 ns at
// 1 KiB on a Xeon core); below it both take well under the call around them.
constexpr size_t FOLD_MIN = 128;
constexpr size_t PREFETCH = 4096;  // bytes ahead of the fold's loads

// x^k mod P
constexpr uint16_t xpow_mod(unsigned k) {
  uint32_t r = 1;
  for (unsigned i = 0; i < k; ++i) {
    r <<= 1;
    if (r & 0x10000) r ^= POLY;
  }
  return (uint16_t)r;
}

struct Table {
  uint16_t t[16][256];
};

// t[j][q] = q * x^(16 + 8j) mod P: t[0] is the byte-at-a-time table, and
// t[j] is t[j - 1] advanced by one more byte of zeros.
constexpr Table make_table() {
  Table tab{};
  for (unsigned q = 0; q < 256; ++q) {
    uint16_t r = (uint16_t)(q << 8);
    for (int b = 0; b < 8; ++b) r = (uint16_t)((r << 1) ^ ((r & 0x8000) ? (POLY & 0xFFFF) : 0));
    tab.t[0][q] = r;
  }
  for (int j = 1; j < 16; ++j)
    for (unsigned q = 0; q < 256; ++q) {
      uint16_t r = tab.t[j - 1][q];
      tab.t[j][q] = (uint16_t)((r << 8) ^ tab.t[0][r >> 8]);
    }
  return tab;
}

alignas(64) constexpr Table TABLE = make_table();

// The register r (not inverted) after the n bytes at p.
uint16_t table_raw(uint16_t r, const uint8_t* p, size_t n) {
  const auto& t = TABLE.t;
  for (; n >= 16; n -= 16, p += 16) {
    r = (uint16_t)(t[15][p[0] ^ (r >> 8)] ^ t[14][p[1] ^ (r & 0xFF)] ^ t[13][p[2]] ^ t[12][p[3]] ^
                   t[11][p[4]] ^ t[10][p[5]] ^ t[9][p[6]] ^ t[8][p[7]] ^ t[7][p[8]] ^ t[6][p[9]] ^
                   t[5][p[10]] ^ t[4][p[11]] ^ t[3][p[12]] ^ t[2][p[13]] ^ t[1][p[14]] ^ t[0][p[15]]);
  }
  for (; n; --n, ++p) r = (uint16_t)((r << 8) ^ t[0][p[0] ^ (r >> 8)]);
  return r;
}

#if CRC16_HAS_FOLD
#define FOLD_TARGET __attribute__((target("pclmul,ssse3")))

bool cpu_has_fold() {
  static const bool has = __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("ssse3");
  return has;
}

// The 16 bytes in reverse order.
FOLD_TARGET inline __m128i reverse(__m128i x) {
  return _mm_shuffle_epi8(x, _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15));
}

// 16 bytes as a polynomial: the first byte's top bit is x^127.
FOLD_TARGET inline __m128i load_be(const uint8_t* p) { return reverse(_mm_loadu_si128((const __m128i*)p)); }

// Fold constants for a stride of S bits: the high half of an accumulator is
// multiplied by x^(S + 64) mod P, the low half by x^S mod P.
template <unsigned S>
FOLD_TARGET inline __m128i stride() {
  constexpr uint16_t hi = xpow_mod(S + 64), lo = xpow_mod(S);
  return _mm_set_epi64x(hi, lo);
}

// x * x^s, congruent mod P, in 128 bits: each product is at most 64 + 15 bits.
FOLD_TARGET inline __m128i fold(__m128i x, __m128i k) {
  return _mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x11), _mm_clmulepi64_si128(x, k, 0x00));
}

// The register after the first floor(n / 16) * 16 bytes at p (n >= 16),
// from register r; *used gets that byte count.
FOLD_TARGET uint16_t fold_raw(uint16_t r, const uint8_t* p, size_t n, size_t* used) {
  const __m128i k128 = stride<128>(), k512 = stride<512>();
  __m128i x0 = _mm_xor_si128(load_be(p), _mm_slli_si128(_mm_cvtsi32_si128(r), 14));
  size_t i = 16;
  if (n >= 64) {
    __m128i x1 = load_be(p + 16), x2 = load_be(p + 32), x3 = load_be(p + 48);
    for (i = 64; i + 64 <= n; i += 64) {
      // A file's bytes come from DRAM: a prefetch one page ahead takes a 5.6 MB
      // read from 5.7 to 9-10 GB/s on the H100 host's core (as fast as 512-bit
      // VPCLMULQDQ folds there; 8 lanes without it gain 5%).  A prefetch past the
      // end of the buffer never faults.
      _mm_prefetch((const char*)((uintptr_t)p + i + PREFETCH), _MM_HINT_T0);
      x0 = _mm_xor_si128(fold(x0, k512), load_be(p + i));
      x1 = _mm_xor_si128(fold(x1, k512), load_be(p + i + 16));
      x2 = _mm_xor_si128(fold(x2, k512), load_be(p + i + 32));
      x3 = _mm_xor_si128(fold(x3, k512), load_be(p + i + 48));
    }
    x0 = _mm_xor_si128(fold(x0, k128), x1);
    x0 = _mm_xor_si128(fold(x0, k128), x2);
    x0 = _mm_xor_si128(fold(x0, k128), x3);
  }
  for (; i + 16 <= n; i += 16) x0 = _mm_xor_si128(fold(x0, k128), load_be(p + i));
  alignas(16) uint8_t rest[16];
  _mm_store_si128((__m128i*)rest, reverse(x0));
  *used = i;
  return table_raw(0, rest, 16);
}
#else
bool cpu_has_fold() { return false; }
uint16_t fold_raw(uint16_t r, const uint8_t*, size_t, size_t* used) {
  *used = 0;
  return r;
}
#endif

}  // namespace

// The table path alone, on any host.
extern "C" uint16_t basisu_crc16_table(const uint8_t* data, size_t len, uint16_t crc) {
  return (uint16_t)~table_raw((uint16_t)~crc, data, len);
}

// The fold path at any length: the fold over whole 16-byte chunks (none below
// 16 bytes), the table over the rest; *fold_bytes (if not null) gets the bytes
// the fold consumed.  Only where basisu_crc16_has_fold() is 1.
extern "C" uint16_t basisu_crc16_fold(const uint8_t* data, size_t len, uint16_t crc, size_t* fold_bytes) {
  uint16_t r = (uint16_t)~crc;
  size_t used = 0;
  if (len >= 16) r = fold_raw(r, data, len, &used);
  if (fold_bytes) *fold_bytes = used;
  return (uint16_t)~table_raw(r, data + used, len - used);
}

extern "C" int basisu_crc16_has_fold() { return cpu_has_fold() ? 1 : 0; }

// The CRC of len bytes continuing from crc (0 for a fresh CRC), by the path
// the length and the CPU choose; *fold_bytes (if not null) as above.
extern "C" uint16_t basisu_crc16(const uint8_t* data, size_t len, uint16_t crc, size_t* fold_bytes) {
  if (len >= FOLD_MIN && cpu_has_fold()) return basisu_crc16_fold(data, len, crc, fold_bytes);
  if (fold_bytes) *fold_bytes = 0;
  return basisu_crc16_table(data, len, crc);
}
