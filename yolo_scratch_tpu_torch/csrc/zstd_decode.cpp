// Zstandard frame decoder (RFC 8878), written for reading the JAX package's
// orbax checkpoints (tensorstore writes every OCDBT manifest, B-tree node and
// zarr chunk as a zstd frame) on machines without libzstd.
//
// Decodes any sequence of zstd and skippable frames: raw, RLE and compressed
// blocks; raw, RLE, Huffman (1 or 4 streams, direct or FSE weights) and
// treeless literals; predefined, RLE, FSE and repeat sequence tables; the
// three repeat offsets; the XXH64 content checksum when the frame has one.
// Frames that name a dictionary are refused. Every read is bounds-checked:
// corrupt or truncated input throws, which the C entry point turns into an
// error message and a return of -1.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (nothing to link).
//
// C interface (ctypes, yolo_scratch_tpu_torch/utils/zstd.py):
//   int     yst_zstd_version(void);
//   int64_t yst_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                               char* err, size_t err_cap);
//           -> decoded size (*out malloc'd, free with yst_zstd_free), or -1
//              with a message in err
//   void    yst_zstd_free(uint8_t* p);

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p)); v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16)); v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) { h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3; p += 4; }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bit readers

// Forward little-endian bits (FSE table descriptions).
struct FwdBits {
  const uint8_t* p; size_t n; size_t bit = 0;
  uint32_t peek(int k) const {  // k <= 24; bits past the end read as 0
    uint32_t v = 0;
    size_t b = bit >> 3;
    for (int i = 0; i < 4 && b + i < n; ++i) v |= uint32_t(p[b + i]) << (8 * i);
    return (v >> (bit & 7)) & ((1u << k) - 1);
  }
  void skip(int k) { bit += k; if (bit > n * 8) fail("FSE table description overruns its block"); }
  size_t bytes() const { return (bit + 7) >> 3; }
};

// Backward bits: the stream is one little-endian integer read from its top
// bit down, after the padding (zeros and one 1 bit) of its last byte. Bits
// below the start read as 0; `left` goes negative when they are consumed.
struct BackBits {
  const uint8_t* p; size_t n; int64_t left;
  BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty backward bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("backward bitstream without its end mark");
    left = int64_t(n) * 8 - (8 - highbit(last));
  }
  uint64_t peek(int k) const {  // k <= 56
    if (k == 0) return 0;
    int64_t lo = left - k;
    uint64_t v;
    if (lo >= 0) {
      size_t b = size_t(lo >> 3);
      if (b + 8 <= n) {
        v = rd64(p + b) >> (lo & 7);
      } else {
        v = 0;
        for (size_t i = b; i < n; ++i) v |= uint64_t(p[i]) << (8 * (i - b));
        v >>= (lo & 7);
      }
    } else {
      if (left <= 0) return 0;
      v = (n >= 8 ? rd64(p) : [&] { uint64_t t = 0; for (size_t i = 0; i < n; ++i) t |= uint64_t(p[i]) << (8 * i); return t; }());
      v = (v & ((left >= 64) ? ~0ULL : ((1ULL << left) - 1))) << (-lo);
    }
    return v & ((1ULL << k) - 1);
  }
  uint64_t read(int k) { uint64_t v = peek(k); left -= k; return v; }
};

// ---------------------------------------------------------------- FSE

struct FseEntry { uint16_t sym; uint8_t nbits; uint16_t base; };

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

// Read a normalized distribution (RFC 8878 4.1.1); returns the bytes used.
size_t read_ncount(const uint8_t* p, size_t n, int max_log, int max_sym, std::vector<int16_t>& norm,
                   int& log) {
  FwdBits br{p, n};
  log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) fail("FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  bool prev0 = false;
  norm.assign(size_t(max_sym) + 1, 0);
  while (remaining > 1) {
    if (sym > max_sym) fail("FSE distribution has too many symbols");
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.peek(2);
        br.skip(2);
        n0 += int(r);
        if (r != 3) break;
      }
      if (n0 > max_sym) fail("FSE zero run past the last symbol");
      sym = n0;
      if (br.bit > n * 8) fail("FSE table description truncated");
    }
    int maxv = (2 * threshold - 1) - remaining;
    uint32_t bits = br.peek(nbits);
    int count;
    if (int(bits & uint32_t(threshold - 1)) < maxv) {
      count = int(bits & uint32_t(threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = int(bits & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      br.skip(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    if (sym > max_sym) fail("FSE distribution has too many symbols");
    norm[size_t(sym++)] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) { nbits--; threshold >>= 1; }
  }
  if (remaining != 1) fail("FSE distribution does not sum to its table size");
  norm.resize(size_t(sym));
  if (br.bytes() > n) fail("FSE table description truncated");
  return br.bytes();
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& out) {
  const int size = 1 << log;
  out.log = log;
  out.t.assign(size_t(size), FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE distribution overfills its table");
      out.t[size_t(high--)].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const int mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[size_t(pos)].sym = uint16_t(s);
      do { pos = (pos + step) & mask; } while (pos > high);
    }
  }
  if (pos != 0) fail("FSE distribution does not spread over its table");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = out.t[size_t(u)];
    uint32_t ns = next[e.sym]++;
    if (ns == 0) fail("FSE table state without a count");
    e.nbits = uint8_t(log - highbit(ns));
    e.base = uint16_t((ns << e.nbits) - uint32_t(size));
  }
  out.valid = true;
}

void build_rle(uint8_t sym, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{sym, 0, 0});
  out.valid = true;
}

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> t;  // (symbol << 8) | nbits, indexed by the top max_bits bits
  bool valid = false;
};

// Huffman tree description (RFC 8878 4.2.1); returns the bytes used.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& out) {
  if (n < 1) fail("Huffman tree description truncated");
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  const uint8_t hb = p[0];
  if (hb >= 128) {  // direct 4-bit weights
    nw = hb - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + size_t(hb);
    if (used > n || hb == 0) fail("Huffman weights truncated");
    std::vector<int16_t> norm;
    int log;
    size_t h = read_ncount(p + 1, hb, 6, 255, norm, log);
    if (h >= hb) fail("Huffman weight stream missing");
    FseTable t;
    build_fse(norm, log, t);
    BackBits br(p + 1 + h, hb - h);
    uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
    for (;;) {
      if (nw > 253) fail("too many Huffman weights");
      const FseEntry& e1 = t.t[s1];
      weights[nw++] = uint8_t(e1.sym);
      s1 = e1.base + uint32_t(br.read(e1.nbits));
      if (br.left < 0) { weights[nw++] = uint8_t(t.t[s2].sym); break; }
      const FseEntry& e2 = t.t[s2];
      weights[nw++] = uint8_t(e2.sym);
      s2 = e2.base + uint32_t(br.read(e2.nbits));
      if (br.left < 0) { weights[nw++] = uint8_t(t.t[s1].sym); break; }
    }
  }
  if (nw > 255) fail("too many Huffman weights");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a tree");
  weights[nw++] = uint8_t(highbit(left) + 1);
  out.max_bits = max_bits;
  out.t.assign(size_t(1) << max_bits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      uint32_t span = 1u << (w - 1);
      uint16_t e = uint16_t((s << 8) | (max_bits + 1 - w));
      for (uint32_t i = 0; i < span; ++i) out.t[pos + i] = e;
      pos += span;
    }
  }
  if (pos != (1u << max_bits)) fail("Huffman table not filled");
  out.valid = true;
  return used;
}

// Symbols [0, count) of one stream into dst; the stream must end exactly.
void huf_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* dst, size_t count) {
  BackBits br(p, n);
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const uint16_t e = h.t[size_t(br.peek(mb))];
    dst[i] = uint8_t(e >> 8);
    br.left -= (e & 0xFF);
  }
  if (br.left != 0) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- sequences

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,  30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,  83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;  // the block's literals; grows, never shrinks
};

// One table of the sequences section; returns the bytes used.
size_t read_seq_table(int mode, const uint8_t* p, size_t n, const int16_t* def, int ndef,
                      int def_log, int max_log, int max_sym, FseTable& t, const char* what) {
  switch (mode) {
    case 0: {
      std::vector<int16_t> norm(def, def + ndef);
      build_fse(norm, def_log, t);
      return 0;
    }
    case 1:
      if (n < 1) fail("sequence RLE table truncated");
      if (p[0] > max_sym) fail("sequence RLE symbol out of range");
      build_rle(p[0], t);
      return 1;
    case 2: {
      std::vector<int16_t> norm;
      int log;
      size_t used = read_ncount(p, n, max_log, max_sym, norm, log);
      build_fse(norm, log, t);
      return used;
    }
    default:
      if (!t.valid) fail(what);
      return 0;
  }
}

void decode_block(const uint8_t* p, size_t n, FrameState& st, std::vector<uint8_t>& out,
                  size_t frame_start) {
  // ---- literals section
  if (n < 1) fail("compressed block empty");
  const uint8_t b0 = p[0];
  const int ltype = b0 & 3, sfmt = (b0 >> 2) & 3;
  size_t hsize, regen, csize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) { hsize = 1; regen = b0 >> 3; }
    else if (sfmt == 1) { hsize = 2; if (n < 2) fail("literals header truncated"); regen = (b0 >> 4) + (size_t(p[1]) << 4); }
    else { hsize = 3; if (n < 3) fail("literals header truncated"); regen = (b0 >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12); }
  } else {
    hsize = sfmt < 2 ? 3 : size_t(sfmt + 2);
    if (n < hsize) fail("literals header truncated");
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= uint64_t(p[i]) << (8 * i);
    if (sfmt < 2) { regen = (h >> 4) & 0x3FF; csize = (h >> 14) & 0x3FF; streams = sfmt == 0 ? 1 : 4; }
    else if (sfmt == 2) { regen = (h >> 4) & 0x3FFF; csize = (h >> 18) & 0x3FFF; streams = 4; }
    else { regen = (h >> 4) & 0x3FFFF; csize = (h >> 22) & 0x3FFFF; streams = 4; }
  }
  if (regen > (128u << 10)) fail("literals larger than a block");
  if (st.lit.size() < regen) st.lit.resize(regen);
  uint8_t* const lit = st.lit.data();
  size_t pos = hsize;
  if (ltype == 0) {
    if (pos + regen > n) fail("raw literals truncated");
    if (regen) std::memcpy(lit, p + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > n) fail("RLE literals truncated");
    std::memset(lit, p[pos], regen);
    pos += 1;
  } else {
    if (pos + csize > n) fail("compressed literals truncated");
    const uint8_t* q = p + pos;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(q, qn, st.huf);
      q += used;
      qn -= used;
    } else if (!st.huf.valid) {
      fail("treeless literals without an earlier Huffman table");
    }
    if (streams == 1) {
      huf_stream(st.huf, q, qn, lit, regen);
    } else {
      if (qn < 6) fail("4-stream literals without their jump table");
      size_t s1 = q[0] | (size_t(q[1]) << 8), s2 = q[2] | (size_t(q[3]) << 8),
             s3 = q[4] | (size_t(q[5]) << 8);
      if (6 + s1 + s2 + s3 > qn) fail("4-stream literals jump table out of range");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals too short");
      const uint8_t* at = q + 6;
      huf_stream(st.huf, at, s1, lit, seg);
      huf_stream(st.huf, at + s1, s2, lit + seg, seg);
      huf_stream(st.huf, at + s1 + s2, s3, lit + 2 * seg, seg);
      huf_stream(st.huf, at + s1 + s2 + s3, s4, lit + 3 * seg, regen - 3 * seg);
    }
    pos += csize;
  }

  // ---- sequences section
  if (pos >= n) fail("sequences section missing");
  size_t nseq = p[pos];
  if (nseq == 0) {
    pos += 1;
  } else if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("sequence count truncated");
    nseq = p[pos + 1] + (size_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const size_t base = out.size();
  if (nseq == 0) {
    if (pos != n) fail("bytes after a block's literals");
    out.insert(out.end(), lit, lit + regen);
    return;
  }
  if (pos >= n) fail("sequence modes missing");
  const uint8_t modes = p[pos++];
  if (modes & 3) fail("reserved sequence mode bits set");
  pos += read_seq_table(modes >> 6, p + pos, n - pos, LL_DEFAULT, 36, 6, 9, 35, st.ll,
                        "repeat literal-length table without an earlier one");
  pos += read_seq_table((modes >> 4) & 3, p + pos, n - pos, OF_DEFAULT, 29, 5, 8, 31, st.of,
                        "repeat offset table without an earlier one");
  pos += read_seq_table((modes >> 2) & 3, p + pos, n - pos, ML_DEFAULT, 53, 6, 9, 52, st.ml,
                        "repeat match-length table without an earlier one");
  if (pos >= n) fail("sequence bitstream missing");
  BackBits br(p + pos, n - pos);
  uint32_t sll = uint32_t(br.read(st.ll.log)), sof = uint32_t(br.read(st.of.log)),
           sml = uint32_t(br.read(st.ml.log));
  size_t lpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry &ell = st.ll.t[sll], &eof = st.of.t[sof], &eml = st.ml.t[sml];
    const uint32_t ofc = eof.sym, llc = ell.sym, mlc = eml.sym;
    if (ofc > 31) fail("offset code out of range");
    uint32_t ofv = (1u << ofc) + uint32_t(br.read(int(ofc)));
    uint32_t ml = ML_BASE[mlc] + uint32_t(br.read(ML_BITS[mlc]));
    uint32_t ll = LL_BASE[llc] + uint32_t(br.read(LL_BITS[llc]));
    uint32_t off;
    if (ofv > 3) {
      off = ofv - 3;
      st.rep[2] = st.rep[1]; st.rep[1] = st.rep[0]; st.rep[0] = off;
    } else {
      uint32_t idx = ofv + (ll == 0 ? 1 : 0);
      if (idx == 1) {
        off = st.rep[0];
      } else if (idx == 2) {
        off = st.rep[1]; st.rep[1] = st.rep[0]; st.rep[0] = off;
      } else {
        off = idx == 3 ? st.rep[2] : st.rep[0] - 1;
        if (off == 0) fail("zero offset");
        st.rep[2] = st.rep[1]; st.rep[1] = st.rep[0]; st.rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.base + uint32_t(br.read(ell.nbits));
      sml = eml.base + uint32_t(br.read(eml.nbits));
      sof = eof.base + uint32_t(br.read(eof.nbits));
    }
    if (br.left < 0) fail("sequence bitstream overrun");
    if (lpos + ll > regen) fail("sequence copies more literals than the block has");
    out.insert(out.end(), lit + lpos, lit + lpos + ll);
    lpos += ll;
    const size_t o = out.size();
    if (off > o - frame_start) fail("match offset before the frame's start");
    out.resize(o + ml);
    uint8_t* d = out.data() + o;
    const uint8_t* s = d - off;
    if (off >= ml) std::memcpy(d, s, ml);
    else for (uint32_t k = 0; k < ml; ++k) d[k] = s[k];  // overlapping: repeats the last `off` bytes
  }
  if (br.left != 0) fail("sequence bitstream not consumed exactly");
  out.insert(out.end(), lit + lpos, lit + regen);
  if (out.size() - base > (128u << 10)) fail("block decodes past 128 KiB");
}

// One frame starting at p (magic already checked); returns the bytes used.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  size_t pos = 4;
  if (pos >= n) fail("frame header truncated");
  const uint8_t fhd = p[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set");
  if (!single) {
    if (pos >= n) fail("frame header truncated");
    pos++;  // window descriptor: offsets are checked against the frame's output instead
  }
  const size_t did_size = did_flag == 3 ? 4 : size_t(did_flag);
  if (pos + did_size > n) fail("frame header truncated");
  uint32_t did = 0;
  for (size_t i = 0; i < did_size; ++i) did |= uint32_t(p[pos + i]) << (8 * i);
  if (did != 0) fail("frame needs a dictionary");
  pos += did_size;
  size_t fcs_size = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
  if (pos + fcs_size > n) fail("frame header truncated");
  uint64_t fcs = 0;
  bool has_fcs = fcs_size > 0;
  for (size_t i = 0; i < fcs_size; ++i) fcs |= uint64_t(p[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  const size_t start = out.size();
  if (has_fcs && fcs < (uint64_t(1) << 34)) out.reserve(start + size_t(fcs));
  FrameState st;
  for (;;) {
    if (pos + 3 > n) fail("block header truncated");
    const uint32_t bh = p[pos] | (uint32_t(p[pos + 1]) << 8) | (uint32_t(p[pos + 2]) << 16);
    pos += 3;
    const int last = bh & 1, btype = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (btype == 3) fail("reserved block type");
    if (bsize > (128u << 10)) fail("block larger than 128 KiB");
    if (btype == 1) {
      if (pos + 1 > n) fail("RLE block truncated");
      out.insert(out.end(), bsize, p[pos]);
      pos += 1;
    } else {
      if (pos + bsize > n) fail("block truncated");
      if (btype == 0) out.insert(out.end(), p + pos, p + pos + bsize);
      else decode_block(p + pos, bsize, st, out, start);
      pos += bsize;
    }
    if (last) break;
  }
  if (has_fcs && out.size() - start != fcs) fail("frame content size mismatch");
  if (checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    const uint32_t want = rd32(p + pos);
    if (uint32_t(xxh64(out.data() + start, out.size() - start)) != want)
      fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  size_t pos = 0;
  if (n == 0) fail("no frame");
  while (pos < n) {
    if (n - pos < 4) fail("frame magic truncated");
    const uint32_t magic = rd32(p + pos);
    if (magic == 0xFD2FB528u) {
      pos += decode_frame(p + pos, n - pos, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("skippable frame truncated");
      const uint64_t len = rd32(p + pos + 4);
      if (len > n - pos - 8) fail("skippable frame truncated");
      pos += 8 + size_t(len);
    } else {
      fail("not a zstd frame (bad magic)");
    }
  }
}

}  // namespace

extern "C" {

int yst_zstd_version(void) { return 1; }

int64_t yst_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, char* err,
                            size_t err_cap) {
  *out = nullptr;
  try {
    std::vector<uint8_t> buf;
    decode_all(src, n, buf);
    uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.empty() ? 1 : buf.size()));
    if (!mem) throw std::bad_alloc();
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    return int64_t(buf.size());
  } catch (const std::exception& e) {
    if (err_cap) {
      std::strncpy(err, e.what(), err_cap - 1);
      err[err_cap - 1] = 0;
    }
    return -1;
  }
}

void yst_zstd_free(uint8_t* p) { std::free(p); }

}  // extern "C"
