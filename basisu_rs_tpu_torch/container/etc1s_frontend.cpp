// The BasisLZ/ETC1S entropy front-end on the host: canonical Huffman tables,
// the endpoint and selector codebook decoders and the sequential prediction
// state machine that turns a slice's bit stream into per-block (endpoint,
// selector) index streams for the device kernels K6-K9 (csrc/etc1s.cu).
//
// The port's own copy of the front-end in basisu_rs_tpu/native/etc1s.cpp
// (without its CRC, which the port keeps in crc16.cpp, and without its
// calibration loop).  container/etc1s_frontend.py builds it with g++ at
// first use, binds it with ctypes and holds it against the plain Python
// front-end in the same module.  C ABI only; error codes are negative, 0 is
// success.
//
// Widths this code is written against: a code length is at most 16 bits,
// and a table whose canonical codes overflow 16 bits (next_code[bits] >
// 0x10000) is refused; a plain read() takes at most 32 bits.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCodeSize = 16;

// ---------------------------------------------------------------------------
// bit reader: LSB-first, reads past the end yield zero bits
// ---------------------------------------------------------------------------
// The next bits of the stream sit in a 64-bit buffer, lowest first.  refill()
// tops it up to 56-63 valid bits with one unaligned 8-byte load (the next
// byte lands at bit `bits`; the bytes the count does not cover are loaded
// again, to the same bits, by the next refill), and a caller peeks with
// `buf & mask` and consumes with skip(n).  A caller refills before any run
// of reads that could take more than 56 bits: the slice loop once a block
// (its pred, delta and selector codes are at most 3 x 16 = 48 bits), read()
// before each VLC chunk (at most 8 bits, so at least 48 remain after a VLC)
// and the slice loop again before the selector-RLE symbol.  Within the last
// 8 bytes a refill loads what is left and zero bytes past it.
struct BitReader {
  const uint8_t* p;    // the next byte a refill loads
  const uint8_t* end;  // one past the stream's last byte
  uint64_t buf = 0;    // the stream from bit 8 * p - bits on
  unsigned bits = 0;   // valid low bits of buf

  BitReader(const uint8_t* data, size_t len) : p(data), end(data + len) {}

  void refill() {
    uint64_t v;
    size_t step = (63 - bits) >> 3;  // the whole bytes free in buf
    if (end - p >= 8) {
      std::memcpy(&v, p, 8);
    } else {  // p stops at the end: the bits past it are zero
      size_t left = (size_t)(end - p);
      v = 0;
      for (size_t k = 0; k < left; ++k) v |= (uint64_t)p[k] << (8 * k);
      if (step > left) step = left;
    }
    buf |= v << bits;
    p += step;
    bits |= 56;
  }
  void skip(unsigned n) {
    buf >>= n;
    bits -= n;
  }
  uint32_t read(int count) {
    refill();
    uint32_t v = (uint32_t)(buf & ((uint64_t(1) << count) - 1));
    skip(count);
    return v;
  }
};

// Symbols a slice decoded, and those that took a subtable.
struct SymbolCounts {
  uint64_t symbols = 0, sub = 0;
};

// ---------------------------------------------------------------------------
// canonical Huffman decoding table (bit-reversed codes)
// ---------------------------------------------------------------------------
struct HuffTable {
  // Two-level lookup: a root table indexed by the next root_bits bits, plus
  // per-prefix subtables for codes longer than root_bits.  root_bits is the
  // table's longest code, capped at kMaxRootBits: codes of up to 12 bits
  // (equal-length codebooks of up to 4,096 entries) take one load from a root
  // of at most 16 KiB, and only codes of 13-16 bits (codebooks up to 16,128
  // entries) take the subtable; a flat 16-bit table would be 256 KiB.
  //
  // entry layout (u32):
  //   leaf:    code_size << 16 | symbol   (code_size >= 1)
  //   branch:  0x80000000 | extra_bits << 24 | subtable_base
  //   invalid: 0
  static constexpr int kMaxRootBits = 12;
  std::vector<uint32_t> entries;  // root
  std::vector<uint32_t> sub;      // subtable pool
  uint32_t mask = 0;
  int root_bits = 0;
  int max_code_size = 0;

  // returns 0 on success
  int build(const uint8_t* code_sizes, int n) {
    uint32_t counts[kMaxCodeSize + 1] = {0};
    max_code_size = 0;
    for (int i = 0; i < n; ++i) {
      counts[code_sizes[i]]++;
      if (code_sizes[i] > max_code_size) max_code_size = code_sizes[i];
    }
    counts[0] = 0;
    uint32_t next_code[kMaxCodeSize + 1] = {0};
    uint32_t total = 0;
    for (int bits = 1; bits <= kMaxCodeSize; ++bits) {
      total = (total + counts[bits - 1]) << 1;
      next_code[bits] = total;
    }
    root_bits = max_code_size < kMaxRootBits ? max_code_size : kMaxRootBits;
    entries.assign(size_t(1) << root_bits, 0);
    sub.clear();
    mask = (uint32_t)entries.size() - 1;

    // pass 1: the longest code under each root prefix sizes its subtable
    uint32_t nc[kMaxCodeSize + 1];
    std::memcpy(nc, next_code, sizeof(nc));
    std::vector<uint8_t> group_max;
    if (max_code_size > root_bits) group_max.assign(entries.size(), 0);
    for (int sym = 0; sym < n; ++sym) {
      int size = code_sizes[sym];
      if (size <= root_bits) {
        if (size) nc[size]++;
        continue;
      }
      uint32_t code = nc[size]++;
      uint32_t rev = 0;
      for (int b = 0; b < size; ++b) rev |= ((code >> b) & 1u) << (size - 1 - b);
      uint32_t ridx = rev & mask;
      if ((uint8_t)size > group_max[ridx]) group_max[ridx] = (uint8_t)size;
    }
    if (!group_max.empty()) {
      for (size_t ridx = 0; ridx < entries.size(); ++ridx) {
        if (!group_max[ridx]) continue;
        uint32_t extra = (uint32_t)group_max[ridx] - root_bits;
        entries[ridx] = 0x80000000u | (extra << 24) | (uint32_t)sub.size();
        sub.insert(sub.end(), size_t(1) << extra, 0);
      }
    }

    // pass 2: leaves (short codes replicate in the root, long codes inside
    // their prefix's subtable; prefix-freeness keeps the two apart)
    for (int sym = 0; sym < n; ++sym) {
      int size = code_sizes[sym];
      if (!size) continue;
      uint32_t code = next_code[size]++;
      uint32_t rev = 0;
      for (int b = 0; b < size; ++b) rev |= ((code >> b) & 1u) << (size - 1 - b);
      uint32_t entry = (uint32_t)sym | ((uint32_t)size << 16);
      if (size <= root_bits) {
        for (size_t fill = rev; fill < entries.size(); fill += size_t(1) << size) entries[fill] = entry;
      } else {
        uint32_t e = entries[rev & mask];
        uint32_t extra = (e >> 24) & 0x7F;
        uint32_t base = e & 0xFFFFFF;
        uint32_t high = rev >> root_bits;
        for (size_t fill = high; fill < (size_t(1) << extra); fill += size_t(1) << (size - root_bits))
          sub[base + fill] = entry;
      }
    }
    for (int bits = 1; bits <= kMaxCodeSize; ++bits)
      if (next_code[bits] > 0x10000u) return -2;
    return 0;
  }

  // The next symbol, its code consumed; -1 where no code matches.  The
  // reader holds at least kMaxCodeSize valid bits (the caller refilled).
  int decode(BitReader& r, SymbolCounts& n) const {
    uint32_t e = entries[(uint32_t)r.buf & mask];
    n.symbols++;
    if ((int32_t)e < 0) {  // branch: a code longer than root_bits
      n.sub++;
      uint32_t extra = (e >> 24) & 0x7F;
      e = sub[(e & 0xFFFFFF) + ((uint32_t)(r.buf >> root_bits) & ((1u << extra) - 1))];
    }
    if (!(e >> 16)) return -1;
    r.skip(e >> 16);
    return (int)(e & 0xFFFF);
  }
  // The codebooks and tables, which count nothing: a refill, then decode.
  int read_symbol(BitReader& r) const {
    SymbolCounts uncounted;
    r.refill();
    return decode(r, uncounted);
  }
};

// scrambled order of the code-length codes' sizes in the stream
constexpr int kClcIndices[21] = {17, 18, 19, 20, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16};

int read_huffman_table(BitReader& r, HuffTable* out) {
  int total_used_syms = (int)r.read(14);
  int num_clc = (int)r.read(5);
  uint8_t clc_sizes[21] = {0};
  for (int i = 0; i < num_clc; ++i) clc_sizes[kClcIndices[i]] = (uint8_t)r.read(3);
  HuffTable clc;
  if (int rc = clc.build(clc_sizes, 21)) return rc;

  std::vector<uint8_t> sizes;
  sizes.reserve(total_used_syms);
  while ((int)sizes.size() < total_used_syms) {
    int sym = clc.read_symbol(r);
    if (sym < 0) return -3;
    if (sym <= 16) {
      sizes.push_back((uint8_t)sym);
    } else if (sym == 17) {
      int count = 3 + (int)r.read(3);
      sizes.insert(sizes.end(), count, 0);
    } else if (sym == 18) {
      int count = 11 + (int)r.read(7);
      sizes.insert(sizes.end(), count, 0);
    } else {  // 19 / 20: repeats
      if (sizes.empty() || sizes.back() == 0) return -4;
      int count = (sym == 19) ? 3 + (int)r.read(2) : 7 + (int)r.read(7);
      sizes.insert(sizes.end(), count, sizes.back());
    }
  }
  return out->build(sizes.data(), (int)sizes.size());
}

uint32_t decode_vlc(BitReader& r, int chunk_bits, int* err) {
  uint32_t chunk_size = 1u << chunk_bits;
  uint32_t chunk_mask = chunk_size - 1;
  uint32_t v = 0;
  int ofs = 0;
  for (;;) {
    uint32_t s = r.read(chunk_bits + 1);  // refills
    v |= (s & chunk_mask) << ofs;
    ofs += chunk_bits;
    if (!(s & chunk_size)) return v;
    if (ofs >= 32) {
      *err = -5;
      return 0;
    }
  }
}

struct Decoder {
  HuffTable endpoint_pred, delta_endpoint, selector, selector_rle;
  uint32_t history_size = 0;
  int num_endpoints = 0, num_selectors = 0, is_video = 0;
};

// The sequential prediction state machine over one slice (mod.rs:188-458).
//
// The pred and selector-class symbols are data-random, so the layout keeps
// only predictable branches (error paths never taken on valid streams, run
// boundaries) and turns the random choices into masks:
//   - endpoint: the candidates of preds 0/1/2 are unconditional loads merged
//     by masks; only pred == 3 branches, since it consumes stream bits;
//   - selector: the fresh-vs-history choice is one load plus the MTF swap or
//     the history append.
// The bit reader and the symbol counts are locals, so they live in
// registers; `counts` receives the counts of a slice that decodes.
template <bool kVideo>
int decode_slice_impl(const Decoder& d, const uint8_t* data, size_t len, int nbx, int nby, uint16_t* ep_out,
                      uint16_t* sel_out, SymbolCounts* counts) {
  const uint32_t num_endpoints = (uint32_t)d.num_endpoints;
  const uint32_t num_selectors = (uint32_t)d.num_selectors;
  const uint32_t hist_size = d.history_size;
  const uint32_t history_rle_sym = hist_size + num_selectors;

  // +1 front pad so the speculative above[bx-1] load is in bounds at bx == 0
  // (its value is never used there: the legality check rejects first)
  std::vector<uint16_t> pred_ep(2 * (size_t)nbx + 1, 0);
  uint16_t* ep_row[2] = {pred_ep.data() + 1, pred_ep.data() + 1 + nbx};
  std::vector<uint8_t> pred_bits_row(2 * (size_t)nbx, 0);
  std::vector<uint32_t> prev_frame;  // (endpoint, selector) pairs, packed
  // the reference allocates the previous frame zeroed per call
  // (mod.rs:236-237): it does not carry over between slices
  if (kVideo) prev_frame.assign((size_t)nbx * nby, 0);

  std::vector<uint16_t> hist(hist_size ? hist_size : 1, 0);
  uint32_t rover = hist_size / 2;

  uint32_t cur_selector_rle_count = 0;
  uint32_t cur_pred_bits = 0;
  uint32_t prev_pred_sym = 0;
  uint32_t pred_repeat_count = 0;
  uint32_t prev_endpoint_index = 0;
  int err = 0;
  BitReader r{data, len};
  SymbolCounts n;

  size_t bi = 0;
  for (int by = 0; by < nby; ++by) {
    int cur_row = by & 1;
    uint16_t* cur = ep_row[cur_row];
    uint16_t* above = ep_row[cur_row ^ 1];
    uint8_t* bits_here = pred_bits_row.data() + (size_t)cur_row * nbx;
    uint8_t* bits_below = pred_bits_row.data() + (size_t)(cur_row ^ 1) * nbx;
    for (int bx = 0; bx < nbx; ++bx, ++bi) {
      r.refill();  // the pred, delta and selector codes: at most 48 bits
      if ((bx & 1) == 0) {
        if ((by & 1) == 0) {
          if (pred_repeat_count != 0) {
            pred_repeat_count--;
            cur_pred_bits = prev_pred_sym;
          } else {
            int sym = d.endpoint_pred.decode(r, n);
            if (sym < 0) return -3;
            if (sym == 256) {  // ENDPOINT_PRED_REPEAT_LAST_SYMBOL
              pred_repeat_count = decode_vlc(r, 4, &err) + 3 - 1;
              if (err) return err;
              cur_pred_bits = prev_pred_sym;
            } else {
              cur_pred_bits = (uint32_t)sym;
              prev_pred_sym = cur_pred_bits;
            }
          }
          bits_below[bx] = (uint8_t)(cur_pred_bits >> 4);
        } else {
          cur_pred_bits = bits_here[bx];
        }
      }

      uint32_t pred = cur_pred_bits & 3;
      cur_pred_bits >>= 2;

      uint32_t endpoint_index;
      if (pred == 3) {
        int delta = d.delta_endpoint.decode(r, n);
        if (delta < 0) return -3;
        uint32_t ei = (uint32_t)delta + prev_endpoint_index;
        if (ei >= num_endpoints) ei -= num_endpoints;
        endpoint_index = ei;
      } else {
        // never taken on valid streams; one predictable test
        if ((unsigned)(((pred == 0) & (bx == 0)) | ((pred == 1) & (by == 0)) |
                       ((pred == 2) & !kVideo & ((bx == 0) | (by == 0)))))
          return -7;
        uint32_t m0 = -(uint32_t)(pred == 0);
        uint32_t m2 = -(uint32_t)(pred == 2);
        uint32_t cand01 = (prev_endpoint_index & m0) | ((uint32_t)above[bx] & ~m0);
        uint32_t cand2 = kVideo ? (prev_frame[bi] & 0xFFFFu) : (uint32_t)above[bx - 1];
        endpoint_index = (cand2 & m2) | (cand01 & ~m2);
      }

      cur[bx] = (uint16_t)endpoint_index;
      prev_endpoint_index = endpoint_index;

      uint32_t selector_index;
      if (!kVideo || pred != 2) {
        uint32_t selector_sym;
        if (cur_selector_rle_count > 0) {
          cur_selector_rle_count--;
          selector_sym = num_selectors;
        } else {
          int sym = d.selector.decode(r, n);
          if (sym < 0) return -3;
          if ((uint32_t)sym == history_rle_sym) {
            r.refill();  // the run symbol may start past the block's 56 bits
            int run_sym = d.selector_rle.decode(r, n);
            if (run_sym < 0) return -3;
            if (run_sym == 63) {
              cur_selector_rle_count = 3 + decode_vlc(r, 7, &err);
              if (err) return err;
            } else {
              cur_selector_rle_count = 3 + (uint32_t)run_sym;
            }
            cur_selector_rle_count--;
            selector_sym = num_selectors;
          } else {
            selector_sym = (uint32_t)sym;
          }
        }

        if (selector_sym >= num_selectors) {
          uint32_t idx = selector_sym - num_selectors;
          if (idx >= hist_size) return -8;  // hist_size == 0 included
          selector_index = hist[idx];
          if (idx != 0) {  // approximate move-to-front
            uint16_t x = hist[idx / 2];
            hist[idx / 2] = hist[idx];
            hist[idx] = x;
          }
        } else {
          if (hist_size > 0) {
            hist[rover] = (uint16_t)selector_sym;
            if (++rover == hist_size) rover = hist_size / 2;
          }
          selector_index = selector_sym;
        }
      } else {
        selector_index = prev_frame[bi] >> 16;
      }

      if (kVideo) prev_frame[bi] = endpoint_index | (selector_index << 16);

      if ((endpoint_index >= num_endpoints) | (selector_index >= num_selectors)) return -9;
      ep_out[bi] = (uint16_t)endpoint_index;
      sel_out[bi] = (uint16_t)selector_index;
    }
  }
  *counts = n;
  return 0;
}

}  // namespace

extern "C" {

// endpoint codebook: out = uint8 [num_endpoints, 4] (r5, g5, b5, inten3)
int etc1s_decode_endpoints(const uint8_t* data, size_t len, int num_endpoints, uint8_t* out) {
  BitReader r{data, len};
  HuffTable models[3], inten;
  for (auto& m : models)
    if (int rc = read_huffman_table(r, &m)) return rc;
  if (int rc = read_huffman_table(r, &inten)) return rc;
  int grayscale = (int)r.read(1);

  int prev_color5[3] = {16, 16, 16};
  uint32_t prev_inten = 0;
  for (int e = 0; e < num_endpoints; ++e) {
    int ds = inten.read_symbol(r);
    if (ds < 0) return -3;
    uint32_t iv = ((uint32_t)ds + prev_inten) & 7;
    prev_inten = iv;
    out[e * 4 + 3] = (uint8_t)iv;
    int channels = grayscale ? 1 : 3;
    for (int c = 0; c < channels; ++c) {
      int p = prev_color5[c];
      // the delta model is chosen by the previous value's range (mod.rs:487-498)
      HuffTable& m = models[p <= 9 ? 0 : (p <= 21 ? 1 : 2)];
      int delta = m.read_symbol(r);
      if (delta < 0) return -3;
      int v = (p + delta) & 31;
      out[e * 4 + c] = (uint8_t)v;
      prev_color5[c] = v;
    }
    if (grayscale) {
      out[e * 4 + 1] = out[e * 4 + 0];
      out[e * 4 + 2] = out[e * 4 + 0];
    }
  }
  return 0;
}

// selector codebook: out = uint8 [num_selectors, 4] row bytes
int etc1s_decode_selectors(const uint8_t* data, size_t len, int num_selectors, uint8_t* out) {
  BitReader r{data, len};
  int global = (int)r.read(1);
  int hybrid = (int)r.read(1);
  int raw = (int)r.read(1);
  if (global || hybrid) return -6;  // unsupported codebook flavors

  if (!raw) {
    HuffTable model;
    if (int rc = read_huffman_table(r, &model)) return rc;
    uint8_t prev[4] = {0, 0, 0, 0};
    for (int s = 0; s < num_selectors; ++s) {
      for (int y = 0; y < 4; ++y) {
        uint8_t cur;
        if (s == 0) {
          cur = (uint8_t)r.read(8);
        } else {
          int d = model.read_symbol(r);
          if (d < 0) return -3;
          cur = (uint8_t)(d ^ prev[y]);
        }
        prev[y] = cur;
        out[s * 4 + y] = cur;
      }
    }
  } else {
    for (int s = 0; s < num_selectors; ++s)
      for (int y = 0; y < 4; ++y) out[s * 4 + y] = (uint8_t)r.read(8);
  }
  return 0;
}

// The four Huffman models and the history size shared by every slice of a
// file; nullptr when a table does not parse.
void* etc1s_create(const uint8_t* tables, size_t len, int num_endpoints, int num_selectors, int is_video) {
  auto* d = new Decoder();
  BitReader r{tables, len};
  if (read_huffman_table(r, &d->endpoint_pred) || read_huffman_table(r, &d->delta_endpoint) ||
      read_huffman_table(r, &d->selector) || read_huffman_table(r, &d->selector_rle)) {
    delete d;
    return nullptr;
  }
  d->history_size = r.read(13);
  d->num_endpoints = num_endpoints;
  d->num_selectors = num_selectors;
  d->is_video = is_video;
  return d;
}

void etc1s_destroy(void* h) { delete static_cast<Decoder*>(h); }

uint32_t etc1s_history_size(void* h) { return static_cast<Decoder*>(h)->history_size; }

// The sequential prediction state machine over one slice.
// ep_out / sel_out: uint16 [nbx * nby].  counts: uint64 [2], the Huffman
// symbols the slice decoded and those its root lookups resolved alone (0
// and 0 where it fails).  The handle is only read, so threads may share it.
int etc1s_decode_slice(const void* h, const uint8_t* data, size_t len, int nbx, int nby, uint16_t* ep_out,
                       uint16_t* sel_out, uint64_t* counts) {
  const Decoder& d = *static_cast<const Decoder*>(h);
  SymbolCounts n;
  int rc = d.is_video ? decode_slice_impl<true>(d, data, len, nbx, nby, ep_out, sel_out, &n)
                      : decode_slice_impl<false>(d, data, len, nbx, nby, ep_out, sel_out, &n);
  counts[0] = n.symbols;
  counts[1] = n.symbols - n.sub;
  return rc;
}

}  // extern "C"
