// yst_inflate: zlib streams (RFC 1950) over deflate (RFC 1951), for the PNG
// decoder. Stored, fixed and dynamic blocks, distances up to 32 KiB, the
// Adler-32 trailer. Every read is bounds-checked: a truncated stream reports
// INFLATE_TRUNCATED, a malformed one INFLATE_BAD_DATA, and neither reads or
// writes outside its buffers. Huffman codes decode through a 10-bit lookup
// table with a canonical bit-by-bit walk for longer codes; the code-set
// checks (over-subscribed, incomplete) are zlib's.

#include <cstring>

#include "yst_codecs.h"

namespace yst {
namespace {

constexpr int kMaxBits = 15;
constexpr int kFastBits = 10;

// LSB-first bit reader over [p, p + n).
struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;

  void fill() {
    while (cnt <= 56 && pos < n) {
      buf |= (uint64_t)p[pos++] << cnt;
      cnt += 8;
    }
  }
  // false when the input has fewer than k bits left
  bool need(int k) {
    if (cnt < k) fill();
    return cnt >= k;
  }
  uint32_t take(int k) {
    uint32_t v = (uint32_t)(buf & ((1ull << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
};

struct Huffman {
  uint16_t count[kMaxBits + 1];
  uint16_t symbol[320];
  uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0 = walk the code
  int max_len;
};

// 0 ok; -1 over-subscribed or (for code-length codes, or any code longer
// than one bit) incomplete, as zlib's inflate_table rejects them.
int build(Huffman* h, const uint8_t* lens, int n, bool code_lengths) {
  std::memset(h->count, 0, sizeof(h->count));
  for (int i = 0; i < n; ++i) h->count[lens[i]]++;
  h->max_len = 0;
  for (int l = kMaxBits; l >= 1; --l)
    if (h->count[l]) {
      h->max_len = l;
      break;
    }
  h->count[0] = 0;
  std::memset(h->fast, 0, sizeof(h->fast));
  if (h->max_len == 0) return code_lengths ? -1 : 0;  // no codes at all
  int left = 1;
  for (int l = 1; l <= kMaxBits; ++l) {
    left <<= 1;
    left -= h->count[l];
    if (left < 0) return -1;
  }
  if (left > 0 && (code_lengths || h->max_len != 1)) return -1;
  uint16_t offs[kMaxBits + 2];
  offs[1] = 0;
  for (int l = 1; l < kMaxBits; ++l) offs[l + 1] = offs[l] + h->count[l];
  for (int i = 0; i < n; ++i)
    if (lens[i]) h->symbol[offs[lens[i]]++] = (uint16_t)i;
  // canonical codes, bit-reversed into the lookup table
  int code = 0, k = 0;
  for (int l = 1; l <= kFastBits; ++l) {
    for (int j = 0; j < h->count[l]; ++j, ++k, ++code) {
      int rev = 0;
      for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
      for (int f = rev; f < (1 << kFastBits); f += 1 << l)
        h->fast[f] = (uint16_t)((l << 9) | h->symbol[k]);
    }
    code <<= 1;
  }
  return 0;
}

// symbol, or -1 on an invalid code, -2 when the input ran out
int decode(BitReader* br, const Huffman* h) {
  if (br->need(kFastBits)) {
    uint16_t e = h->fast[br->buf & ((1u << kFastBits) - 1)];
    if (e) {
      br->take(e >> 9);
      return e & 511;
    }
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= kMaxBits; ++l) {
    if (!br->need(1)) return -2;
    code |= (int)br->take(1);
    int c = h->count[l];
    if (code - c < first) return h->symbol[index + (code - first)];
    index += c;
    first += c;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// Inflate one block's codes. 0 = end of block, else an InflateStatus.
int inflate_codes(BitReader* br, const Huffman* lit, const Huffman* dist,
                  std::vector<uint8_t>* out, size_t limit) {
  for (;;) {
    int sym = decode(br, lit);
    if (sym < 0) return sym == -2 ? INFLATE_TRUNCATED : INFLATE_BAD_DATA;
    if (sym < 256) {
      if (out->size() >= limit) return INFLATE_FULL;
      out->push_back((uint8_t)sym);
      continue;
    }
    if (sym == 256) return 0;
    sym -= 257;
    if (sym >= 29) return INFLATE_BAD_DATA;
    if (!br->need(kLenExtra[sym])) return INFLATE_TRUNCATED;
    size_t len = kLenBase[sym] + br->take(kLenExtra[sym]);
    int ds = decode(br, dist);
    if (ds < 0) return ds == -2 ? INFLATE_TRUNCATED : INFLATE_BAD_DATA;
    if (ds >= 30) return INFLATE_BAD_DATA;
    if (!br->need(kDistExtra[ds])) return INFLATE_TRUNCATED;
    size_t d = kDistBase[ds] + br->take(kDistExtra[ds]);
    size_t have = out->size();
    if (d > have) return INFLATE_BAD_DATA;  // distance too far back
    size_t room = limit - have;
    size_t k = len < room ? len : room;
    out->resize(have + k);
    uint8_t* o = out->data() + have;
    const uint8_t* s = o - d;
    for (size_t i = 0; i < k; ++i) o[i] = s[i];  // overlapping copies repeat
    if (k < len) return INFLATE_FULL;
  }
}

int dynamic_tables(BitReader* br, Huffman* lit, Huffman* dist) {
  if (!br->need(14)) return INFLATE_TRUNCATED;
  int nlen = (int)br->take(5) + 257, ndist = (int)br->take(5) + 1, ncode = (int)br->take(4) + 4;
  if (nlen > 286 || ndist > 30) return INFLATE_BAD_DATA;
  uint8_t lens[320] = {0};
  for (int i = 0; i < ncode; ++i) {
    if (!br->need(3)) return INFLATE_TRUNCATED;
    lens[kClOrder[i]] = (uint8_t)br->take(3);
  }
  Huffman cl;
  if (build(&cl, lens, 19, true)) return INFLATE_BAD_DATA;
  int idx = 0;
  while (idx < nlen + ndist) {
    int sym = decode(br, &cl);
    if (sym < 0) return sym == -2 ? INFLATE_TRUNCATED : INFLATE_BAD_DATA;
    if (sym < 16) {
      lens[idx++] = (uint8_t)sym;
      continue;
    }
    int len = 0, rep;
    if (sym == 16) {
      if (idx == 0) return INFLATE_BAD_DATA;  // repeat with no previous length
      len = lens[idx - 1];
      if (!br->need(2)) return INFLATE_TRUNCATED;
      rep = 3 + (int)br->take(2);
    } else if (sym == 17) {
      if (!br->need(3)) return INFLATE_TRUNCATED;
      rep = 3 + (int)br->take(3);
    } else {
      if (!br->need(7)) return INFLATE_TRUNCATED;
      rep = 11 + (int)br->take(7);
    }
    if (idx + rep > nlen + ndist) return INFLATE_BAD_DATA;
    while (rep--) lens[idx++] = (uint8_t)len;
  }
  if (lens[256] == 0) return INFLATE_BAD_DATA;  // no end-of-block code
  if (build(lit, lens, nlen, false)) return INFLATE_BAD_DATA;
  if (build(dist, lens + nlen, ndist, false)) return INFLATE_BAD_DATA;
  return 0;
}

void fixed_tables(Huffman* lit, Huffman* dist) {
  uint8_t lens[288];
  int i = 0;
  for (; i < 144; ++i) lens[i] = 8;
  for (; i < 256; ++i) lens[i] = 9;
  for (; i < 280; ++i) lens[i] = 7;
  for (; i < 288; ++i) lens[i] = 8;
  build(lit, lens, 288, false);
  for (i = 0; i < 32; ++i) lens[i] = 5;  // 30 and 31 complete the code, never valid
  build(dist, lens, 32, false);
}

}  // namespace

uint32_t adler32(const uint8_t* d, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;  // the largest run before b can overflow
    n -= k;
    while (k--) {
      a += *d++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

InflateResult zlib_inflate(const uint8_t* src, size_t n, std::vector<uint8_t>* out,
                           size_t limit) {
  out->clear();
  if (n < 2) return {INFLATE_TRUNCATED, n};
  int cmf = src[0], flg = src[1];
  if ((cmf * 256 + flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) > 7 || (flg & 0x20))
    return {INFLATE_BAD_DATA, 2};  // bad check, method, window or a preset dictionary
  BitReader br{src + 2, n - 2};
  Huffman lit, dist;
  int last = 0;
  while (!last) {
    if (!br.need(3)) return {INFLATE_TRUNCATED, n};
    last = (int)br.take(1);
    int type = (int)br.take(2);
    int st = 0;
    if (type == 0) {
      br.take(br.cnt & 7);  // to a byte boundary
      if (!br.need(32)) return {INFLATE_TRUNCATED, n};
      uint32_t len = br.take(16), nlen = br.take(16);
      if (len != (~nlen & 0xffff)) return {INFLATE_BAD_DATA, 2 + br.pos};
      while (len && br.cnt >= 8) {  // bytes already in the bit buffer
        if (out->size() >= limit) return {INFLATE_FULL, 2 + br.pos};
        out->push_back((uint8_t)br.take(8));
        --len;
      }
      size_t avail = br.n - br.pos;
      size_t room = limit - out->size();
      size_t k = len < avail ? len : avail;
      if (k > room) k = room;
      out->insert(out->end(), br.p + br.pos, br.p + br.pos + k);
      br.pos += k;
      if (k < len) return {k == room ? INFLATE_FULL : INFLATE_TRUNCATED, 2 + br.pos};
      continue;
    } else if (type == 1) {
      fixed_tables(&lit, &dist);
    } else if (type == 2) {
      st = dynamic_tables(&br, &lit, &dist);
    } else {
      st = INFLATE_BAD_DATA;
    }
    if (!st) st = inflate_codes(&br, &lit, &dist, out, limit);
    if (st) return {(InflateStatus)st, 2 + br.pos - (size_t)(br.cnt / 8)};
  }
  br.take(br.cnt & 7);
  if (!br.need(32)) return {INFLATE_TRUNCATED, n};
  uint32_t want = 0;
  for (int i = 0; i < 4; ++i) want = (want << 8) | br.take(8);
  size_t used = 2 + br.pos - (size_t)(br.cnt / 8);
  bool ok = adler32(out->data(), out->size()) == want;
  return {ok ? INFLATE_OK : INFLATE_BAD_ADLER, used};
}

}  // namespace yst
