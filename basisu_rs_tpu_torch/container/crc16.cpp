// CRC-16/GENIBUS over a byte buffer (reference: src/basis.rs:364-372), the
// checksum of the .basis header and data.  The port's own copy of
// basisu_crc16 in basisu_rs_tpu/native/etc1s.cpp; container/crc.py builds it
// with g++ at first use and holds it against a table-driven Python version.
#include <stddef.h>
#include <stdint.h>

extern "C" uint16_t basisu_crc16(const uint8_t* data, size_t len, uint16_t crc) {
  // byte recurrence, table-free
  crc = (uint16_t)~crc;
  for (size_t i = 0; i < len; ++i) {
    uint16_t q = (uint16_t)(data[i] ^ (crc >> 8));
    uint16_t k = (uint16_t)((q >> 4) ^ q);
    crc = (uint16_t)((((crc << 8) ^ k) ^ (k << 5)) ^ (k << 12));
  }
  return (uint16_t)~crc;
}
