// yst_png: PNG decode to 8-bit gray or RGB, as libpng's simplified API
// (png_image_finish_read with PNG_FORMAT_GRAY / PNG_FORMAT_RGB and a null
// background) gives it. Every colour type and bit depth, both interlace
// methods, the five filters, PLTE and tRNS, CRC-32 checks; the image data
// inflates through yst_inflate.cpp.
//
// The conversions are libpng's, held against it by the tests: an 8-bit
// file is taken as sRGB, a 16-bit one as linear light, so 16-bit samples go
// through libpng's 16-to-8 gamma table (11 significant bits); RGB -> gray
// mixes linear values with libpng's default weights (6968, 23434, 2366) /
// 32768 through its 8-bit (or 16-bit) gamma tables; gray -> RGB replicates.
// Alpha is removed by compositing onto black, where libpng composites onto
// the caller's buffer (the port's is zeroed): opaque pixels are the colour,
// transparent ones 0, and partly transparent ones follow libpng's own
// arithmetic path by path (see Converter::blend); colour + alpha -> gray is
// within 1 of libpng, whose sRGB encoder is a table. gAMA, cHRM, sRGB, iCCP
// and sBIT are not read: every 8-bit file decodes as sRGB. 16-bit Adam7
// files decode to their true pixels (libpng 1.6.39's simplified API garbles
// the rows that several passes fill).
//
// Status follows libpng's: a file that ends, or whose critical chunk fails
// its CRC, before the image data is complete fails, as does an Adler-32
// mismatch; extra data after the last row is a warning in libpng and
// decodes, as does a missing or damaged IEND (libpng never reads it).

#include <cmath>
#include <cstdlib>
#include <cstring>

#include "yst_codecs.h"

namespace yst {
namespace {

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

constexpr uint32_t tag(char a, char b, char c, char d) {
  return ((uint32_t)(uint8_t)a << 24) | ((uint32_t)(uint8_t)b << 16) |
         ((uint32_t)(uint8_t)c << 8) | (uint32_t)(uint8_t)d;
}

// Read-only tables, built once (function-local statics are initialised
// thread-safely) and shared by every decoding thread.
struct Tables {
  uint32_t crc[256];
  uint8_t to_linear8[256];    // libpng gamma_to_1: sRGB 8-bit -> linear 8-bit
  uint8_t from_linear8[256];  // libpng gamma_from_1: linear 8-bit -> sRGB 8-bit
  uint8_t lin16_to8[2048];    // libpng's 16-to-8 gamma table, by the top 11 bits
  uint16_t from_linear16[2048];  // gamma_16_from_1, by the top 11 bits
  uint8_t lin8_to_srgb[256];     // PNG_sRGB_FROM_LINEAR of an 8-bit linear value
  uint16_t srgb_to_lin16[256];   // png_sRGB_table
  Tables() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      crc[n] = c;
    }
    // png_gamma_8bit_correct with libpng's fixed-point exponents
    // (png_reciprocal(45455) = 219998, png_reciprocal(220000) = 45455)
    for (int i = 0; i < 256; ++i) {
      to_linear8[i] = gamma8(i, 219998);
      from_linear8[i] = gamma8(i, 45455);
      double v = i / 255.0;
      srgb_to_lin16[i] = (uint16_t)std::lround(
          65535 * (v <= 0.04045 ? v / 12.92 : std::pow((v + 0.055) / 1.055, 2.4)));
      double e = v <= 0.0031308 ? v * 12.92 : 1.055 * std::pow(v, 1 / 2.4) - 0.055;
      lin8_to_srgb[i] = (uint8_t)std::lround(255 * e);
    }
    // libpng's sRGB tables (png_sRGB_base / _delta) round these two the other way
    lin8_to_srgb[110] += 1;
    lin8_to_srgb[129] -= 1;
    // png_build_16to8_table(shift 5, gamma 2.2): each 8-bit output i covers
    // the 11-bit inputs below the boundary of i + 0.5
    unsigned last = 0;
    for (unsigned i = 0; i < 255; ++i) {
      unsigned out = i * 257u;
      uint32_t bound = gamma16(out + 128u, 220000);
      bound = (bound * 2047u + 32768u) / 65535u + 1u;
      while (last < bound && last < 2048) lin16_to8[last++] = (uint8_t)i;
    }
    while (last < 2048) lin16_to8[last++] = 255;
    for (int l = 0; l < 2048; ++l)
      from_linear16[l] = (uint16_t)std::floor(65535. * std::pow(l / 2047., 45455 * .00001) + .5);
  }
  static uint8_t gamma8(int v, int g) {
    if (v <= 0 || v >= 255) return (uint8_t)v;
    return (uint8_t)std::floor(255 * std::pow(v / 255., g * .00001) + .5);
  }
  static uint32_t gamma16(unsigned v, int g) {
    if (v == 0 || v >= 65535) return v;
    return (uint32_t)std::floor(65535 * std::pow((int)v / 65535., g * .00001) + .5);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint32_t crc32(const uint8_t* d, size_t n) {
  const Tables& t = tables();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = t.crc[(c ^ d[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint8_t scale16(uint32_t v) {  // png_do_scale_16_to_8
  int32_t tmp = (int32_t)(v >> 8);
  tmp += (((int32_t)(v & 0xff) - tmp + 128) * 65535) >> 24;
  return (uint8_t)tmp;
}

// PNG_sRGB_FROM_LINEAR: a linear value scaled by 255 * 65535 -> sRGB 8-bit
uint8_t srgb_from_linear(uint32_t x) {
  double l = x / (255.0 * 65535.0);
  double e = l <= 0.0031308 ? l * 12.92 : 1.055 * std::pow(l, 1 / 2.4) - 0.055;
  return (uint8_t)std::lround(255 * e);
}

struct Header {
  uint32_t w, h;
  int depth, ctype, interlace;
  int in_ch;       // samples per pixel in the file: 1, 2, 3, 4 (palette: 1)
  int bits_px;     // bits per pixel in the file
  uint8_t pal[256][4];
  bool has_trns = false;
  uint16_t trns[3];  // gray / RGB key colour
};

// One pixel, expanded: samples at the file's precision (8 or 16 bits) and
// whether an alpha channel applies, converted to the requested channels.
struct Converter {
  const Tables& t = tables();
  bool is16, color, alpha, palette;
  int out_ch;

  // v: up to 3 colour samples, a: alpha (max = opaque)
  void put(const uint32_t* v, uint32_t a, uint8_t* o) const {
    if (alpha && a != (is16 ? 65535u : 255u)) {
      blend(v, a, o);
      return;
    }
    if (!color) {
      uint8_t g = is16 ? t.lin16_to8[v[0] >> 5] : (uint8_t)v[0];
      for (int c = 0; c < out_ch; ++c) o[c] = g;
      return;
    }
    if (out_ch == 3) {
      for (int c = 0; c < 3; ++c) o[c] = is16 ? t.lin16_to8[v[c] >> 5] : (uint8_t)v[c];
      return;
    }
    o[0] = gray(v);
  }

  // png_do_rgb_to_gray with libpng's gamma tables
  uint8_t gray(const uint32_t* v) const {
    if (v[0] == v[1] && v[0] == v[2]) return is16 ? t.lin16_to8[v[0] >> 5] : (uint8_t)v[0];
    if (!is16)
      return t.from_linear8[(6968 * t.to_linear8[v[0]] + 23434 * t.to_linear8[v[1]] +
                             2366 * t.to_linear8[v[2]] + 16384) >> 15];
    uint32_t lin[3];
    for (int c = 0; c < 3; ++c) lin[c] = ((v[c] >> 5) * 65535u + 1024u) / 2047u;
    uint32_t g16 = (6968 * lin[0] + 23434 * lin[1] + 2366 * lin[2] + 16384) >> 15;
    return scale16(t.from_linear16[g16 >> 5]);
  }

  // 0 < alpha < max, as png_image_read_composite finishes libpng's
  // PNG_ALPHA_OPTIMIZED compose onto a zeroed buffer: the colour goes to
  // linear light through libpng's gamma tables, is premultiplied there
  // (png_composite / png_composite_16) and cut to 8 bits; a pixel whose
  // 8-bit alpha is still below 255 is then re-encoded to sRGB, one that
  // rounds to 255 is kept linear, one that rounds to 0 stays 0.
  void blend(const uint32_t* v, uint32_t a, uint8_t* o) const {
    int n = color ? 3 : 1;
    uint32_t lin[3];
    uint32_t a8;
    if (a == 0) {
      std::memset(o, 0, out_ch);
      return;
    }
    if (color && out_ch == 1) {
      // colour + alpha -> gray: libpng converts to 8-bit sRGB gray + alpha,
      // then composites locally (png_image_read_background) in 16-bit linear
      uint32_t a8 = is16 ? scale16(a) : a;
      uint8_t g = gray(v);
      o[0] = a8 == 0 ? 0 : a8 == 255 ? g : srgb_from_linear((uint32_t)t.srgb_to_lin16[g] * a8);
      return;
    }
    if (palette) {
      // png_init_read_transformations composites the palette entries
      // themselves, back through gamma_from_1
      for (int c = 0; c < 3; ++c) {
        uint32_t t16 = t.to_linear8[v[c]] * a + 128;
        o[c] = t.from_linear8[(t16 + (t16 >> 8)) >> 8];
      }
      return;
    }
    if (!is16) {
      for (int c = 0; c < n; ++c) {
        uint32_t t16 = t.to_linear8[v[c]] * a + 128;
        lin[c] = (t16 + (t16 >> 8)) >> 8;
      }
      a8 = a;
    } else {
      for (int c = 0; c < n; ++c) {
        uint32_t l16 = ((v[c] >> 5) * 65535u + 1024u) / 2047u;
        lin[c] = scale16((uint32_t)(((uint64_t)l16 * a + 32767u) / 65535u));
      }
      a8 = scale16(a);
    }
    if (a8 == 0) {
      std::memset(o, 0, out_ch);
      return;
    }
    uint8_t enc[3];
    for (int c = 0; c < n; ++c) enc[c] = a8 == 255 ? (uint8_t)lin[c] : t.lin8_to_srgb[lin[c]];
    if (!color) {
      std::memset(o, enc[0], out_ch);
    } else if (out_ch == 3) {
      std::memcpy(o, enc, 3);
    } else {
      o[0] = gray_of_linear(lin, a8);
    }
  }

  // RGB + alpha -> gray: libpng composites locally (png_image_read_background)
  uint8_t gray_of_linear(const uint32_t* lin, uint32_t a8) const {
    uint32_t g = (6968 * lin[0] + 23434 * lin[1] + 2366 * lin[2] + 16384) >> 15;
    return a8 == 255 ? (uint8_t)g : t.lin8_to_srgb[g];
  }
};

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo one row's filter in place; prev is the unfiltered row above (zeros
// for the first row of a pass). false on an unknown filter type.
bool unfilter(int type, uint8_t* row, const uint8_t* prev, size_t len, int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < len; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < len; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < len; ++i)
        row[i] += (uint8_t)(((i >= (size_t)bpp ? row[i - bpp] : 0) + prev[i]) >> 1);
      return true;
    case 4:
      for (size_t i = 0; i < len; ++i) {
        int a = i >= (size_t)bpp ? row[i - bpp] : 0, c = i >= (size_t)bpp ? prev[i - bpp] : 0;
        row[i] += (uint8_t)paeth(a, prev[i], c);
      }
      return true;
    default:
      return false;
  }
}

// Samples of pixel x of an unfiltered row -> colour values and alpha.
void pixel(const Header& hd, const uint8_t* row, uint32_t x, uint32_t* v, uint32_t* a) {
  int d = hd.depth;
  *a = d == 16 ? 65535u : 255u;
  if (hd.ctype == 3) {  // palette: RGB(A) 8-bit
    uint32_t idx = d == 8 ? row[x] : (row[x * d / 8] >> (8 - d - (x * d) % 8)) & ((1 << d) - 1);
    const uint8_t* e = hd.pal[idx];
    v[0] = e[0], v[1] = e[1], v[2] = e[2], *a = e[3];
    return;
  }
  if (d < 8) {  // gray at 1, 2, 4 bits, expanded as png_do_expand does
    uint32_t s = (row[x * d / 8] >> (8 - d - (x * d) % 8)) & ((1 << d) - 1);
    v[0] = s * (d == 1 ? 0xff : d == 2 ? 0x55 : 0x11);
    if (hd.has_trns) {
      uint32_t key = hd.trns[0] & ((1 << d) - 1);
      if (s == key) *a = 0;
    }
    return;
  }
  int n = hd.in_ch;
  for (int c = 0; c < n; ++c)
    v[c] = d == 16 ? (uint32_t)(row[(x * n + c) * 2] << 8 | row[(x * n + c) * 2 + 1])
                   : row[x * n + c];
  if (hd.ctype == 4) {
    *a = v[1];
  } else if (hd.ctype == 6) {
    *a = v[3];
  } else if (hd.has_trns) {
    uint32_t m = d == 16 ? 0xffff : 0xff;
    bool key = hd.ctype == 0 ? v[0] == (hd.trns[0] & m)
                             : v[0] == (hd.trns[0] & m) && v[1] == (hd.trns[1] & m) &&
                                   v[2] == (hd.trns[2] & m);
    if (key) *a = 0;
  }
}

}  // namespace

uint8_t* png_decode(const uint8_t* d, size_t n, int channels, int* w_out, int* h_out) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (n < 8 || std::memcmp(d, sig, 8) != 0 || (channels != 1 && channels != 3)) return nullptr;
  Header hd;
  std::memset(hd.pal, 0, sizeof(hd.pal));
  for (auto& e : hd.pal) e[3] = 255;
  bool have_ihdr = false, have_plte = false;
  size_t pos = 8;
  // the first run of IDAT chunks: [start, data, len] of each
  struct Idat {
    size_t data, len;
    bool crc_ok, whole;
  };
  std::vector<Idat> idats;
  for (;;) {
    if (pos + 8 > n) return nullptr;  // libpng reads past the end: error
    uint32_t len = be32(d + pos);
    uint32_t type = be32(d + pos + 4);
    if (len > 0x7fffffffu) return nullptr;
    for (int i = 0; i < 4; ++i) {
      uint8_t c = d[pos + 4 + i];
      if (!((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z'))) return nullptr;
    }
    const uint8_t* body = d + pos + 8;
    size_t end = pos + 8 + (size_t)len + 4;
    bool whole = end <= n;
    bool crc_ok = whole && crc32(d + pos + 4, (size_t)len + 4) == be32(body + len);
    if (type == tag('I', 'D', 'A', 'T')) {
      if (!have_ihdr || (hd.ctype == 3 && !have_plte)) return nullptr;
      if (whole) {
        idats.push_back({pos + 8, len, crc_ok, true});
      } else {
        size_t avail = n > pos + 8 ? n - pos - 8 : 0;
        idats.push_back({pos + 8, avail < len ? avail : len, false, false});
      }
      if (!whole) break;
      pos = end;
      if (pos + 8 <= n && be32(d + pos + 4) == tag('I', 'D', 'A', 'T')) continue;
      break;  // the image data ends here; libpng reads no further chunk
    }
    if (!whole) return nullptr;
    if (!have_ihdr && type != tag('I', 'H', 'D', 'R')) return nullptr;
    bool critical = !(d[pos + 4] & 0x20);
    if (len > 8000000u) return nullptr;  // PNG_USER_CHUNK_MALLOC_MAX
    if (type == tag('I', 'H', 'D', 'R')) {
      if (have_ihdr || len != 13 || !crc_ok) return nullptr;
      hd.w = be32(body);
      hd.h = be32(body + 4);
      hd.depth = body[8];
      hd.ctype = body[9];
      hd.interlace = body[12];
      if (hd.w == 0 || hd.h == 0 || hd.w > 1000000u || hd.h > 1000000u) return nullptr;
      if (body[10] != 0 || body[11] != 0 || hd.interlace > 1) return nullptr;
      int dd = hd.depth;
      bool ok;
      switch (hd.ctype) {
        case 0: ok = dd == 1 || dd == 2 || dd == 4 || dd == 8 || dd == 16; hd.in_ch = 1; break;
        case 2: ok = dd == 8 || dd == 16; hd.in_ch = 3; break;
        case 3: ok = dd == 1 || dd == 2 || dd == 4 || dd == 8; hd.in_ch = 1; break;
        case 4: ok = dd == 8 || dd == 16; hd.in_ch = 2; break;
        case 6: ok = dd == 8 || dd == 16; hd.in_ch = 4; break;
        default: ok = false;
      }
      if (!ok) return nullptr;
      hd.bits_px = hd.in_ch * dd;
      have_ihdr = true;
    } else if (type == tag('P', 'L', 'T', 'E')) {
      if (hd.ctype == 3) {
        if (have_plte || !crc_ok || len % 3 || len == 0 || len > 768) return nullptr;
        uint32_t num = len / 3, cap = 1u << hd.depth;
        if (num > cap) num = cap;  // libpng drops entries past the bit depth
        for (uint32_t i = 0; i < num; ++i)
          for (int c = 0; c < 3; ++c) hd.pal[i][c] = body[i * 3 + c];
        have_plte = true;
      }
      // PLTE of a non-palette image is only a suggestion: ignored
    } else if (type == tag('t', 'R', 'N', 'S')) {
      if (crc_ok && !hd.has_trns) {
        if (hd.ctype == 3 && have_plte && len >= 1 && len <= 256) {
          for (uint32_t i = 0; i < len; ++i) hd.pal[i][3] = body[i];
          hd.has_trns = true;
        } else if (hd.ctype == 0 && len == 2) {
          hd.trns[0] = (uint16_t)(body[0] << 8 | body[1]);
          hd.has_trns = true;
        } else if (hd.ctype == 2 && len == 6) {
          for (int c = 0; c < 3; ++c) hd.trns[c] = (uint16_t)(body[2 * c] << 8 | body[2 * c + 1]);
          hd.has_trns = true;
        }
      }
    } else if (type == tag('I', 'E', 'N', 'D')) {
      return nullptr;  // IEND before any image data
    } else if (critical) {
      return nullptr;  // an unknown critical chunk
    }
    pos = end;
  }

  // Adam7 passes (x0, y0, dx, dy), or one pass for a plain image
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int(*passes)[4] = hd.interlace ? kAdam7 : kPlain;
  int npass = hd.interlace ? 7 : 1;
  size_t need = 0;
  for (int p = 0; p < npass; ++p) {
    uint64_t pw = hd.w > (uint32_t)passes[p][0]
                      ? (hd.w - passes[p][0] + passes[p][2] - 1) / passes[p][2] : 0;
    uint64_t ph = hd.h > (uint32_t)passes[p][1]
                      ? (hd.h - passes[p][1] + passes[p][3] - 1) / passes[p][3] : 0;
    if (pw && ph) need += (size_t)(ph * (1 + (pw * hd.bits_px + 7) / 8));
  }

  std::vector<uint8_t> zdata;
  size_t total = 0;
  for (auto& c : idats) total += c.len;
  zdata.reserve(total);
  for (auto& c : idats) zdata.insert(zdata.end(), d + c.data, d + c.data + c.len);
  std::vector<uint8_t> raw;
  InflateResult r = zlib_inflate(zdata.data(), zdata.size(), &raw, need);
  if (raw.size() < need) return nullptr;  // not enough image data
  // libpng finishes (and CRC-checks) every IDAT chunk up to the one where
  // the stream ends; a stream that has not ended needs more IDAT data
  if (r.status == INFLATE_TRUNCATED || r.status == INFLATE_BAD_ADLER) return nullptr;
  size_t seen = 0;
  for (auto& c : idats) {
    if (!c.crc_ok) return nullptr;
    seen += c.len;
    if (r.status != INFLATE_FULL && seen >= r.consumed) break;
  }

  const size_t W = hd.w, H = hd.h;
  uint8_t* out = (uint8_t*)std::calloc(W * H * channels, 1);
  if (!out) return nullptr;
  Converter cv{tables(), hd.depth == 16, hd.ctype == 2 || hd.ctype == 3 || hd.ctype == 6,
               hd.ctype == 4 || hd.ctype == 6 || hd.has_trns, hd.ctype == 3, channels};
  int bpp = (hd.bits_px + 7) / 8;
  const uint8_t* src = raw.data();
  for (int p = 0; p < npass; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    size_t pw = W > (size_t)x0 ? (W - x0 + dx - 1) / dx : 0;
    size_t ph = H > (size_t)y0 ? (H - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    size_t rowlen = (pw * hd.bits_px + 7) / 8;
    std::vector<uint8_t> prev(rowlen, 0), cur(rowlen);
    for (size_t y = 0; y < ph; ++y) {
      int ftype = *src++;
      std::memcpy(cur.data(), src, rowlen);
      src += rowlen;
      if (!unfilter(ftype, cur.data(), prev.data(), rowlen, bpp)) {
        std::free(out);
        return nullptr;
      }
      uint8_t* orow = out + ((y0 + y * dy) * W) * channels;
      uint32_t v[4], a;
      for (size_t x = 0; x < pw; ++x) {
        pixel(hd, cur.data(), (uint32_t)x, v, &a);
        cv.put(v, a, orow + (x0 + x * dx) * channels);
      }
      cur.swap(prev);
    }
  }
  *w_out = (int)W;
  *h_out = (int)H;
  return out;
}

}  // namespace yst
