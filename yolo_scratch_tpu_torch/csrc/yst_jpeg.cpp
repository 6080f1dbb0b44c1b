// yst_jpeg: JPEG decode as libjpeg-turbo 2.1's jpeg_read_scanlines gives it
// with out_color_space JCS_GRAYSCALE or JCS_RGB, scale_num/8 (num 1..8), the
// default islow IDCT, fancy upsampling and block smoothing, and nothing else
// of libjpeg.
//
// Supported: 8-bit JPEGs of 1 or 3 components, sequential or progressive,
// Huffman-coded (SOF0, SOF1, SOF2) or arithmetic-coded (SOF9, SOF10, with
// the DAC conditioning or libjpeg's defaults), any sampling factors
// libjpeg-turbo upsamples (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), restart
// intervals, the JFIF / Adobe colour markers, libjpeg-turbo's default
// Huffman tables for slots 0 and 1 of sequential files. 12-bit, lossless
// (SOF3, SOF11) and hierarchical files fail with nullptr.
//
// The whole file is entropy-decoded into per-component coefficient arrays
// first (as libjpeg does for multi-scan files), then each component is
// inverse-transformed at its scaled size, upsampled and colour-converted.
// Each stage is libjpeg-turbo's integer arithmetic:
//   * entropy decoding: jdhuff.c / jdphuff.c, and jdarith.c's QM decoder
//     with the probability estimation of jaritab.c;
//   * block smoothing (jdcoefct.c's 5x5 form): a progressive file whose
//     coefficients 1..9 are not all fully refined when the data ends has
//     them estimated from the neighbouring blocks' DC values;
//   * the IDCTs: jpeg_idct_islow at 8x8 and jidctred.c's 2x2 and 4x4 as
//     its SSE2/AVX2 code computes them (16-bit lanes and 32-bit sums; equal
//     to the C code on valid data), the 1x1, and jidctint.c's 3x3, 5x5, 6x6,
//     7x7, 10x10, 12x12 and 14x14 (a scaled decode runs the chroma IDCT at
//     twice the luma's size where the sampling allows, as jdmaster.c
//     chooses per component);
//   * upsampling: h2v1, h1v2 and h2v2 "fancy" triangle filters with their
//     rounding biases (off at 1/8 scale), box replication otherwise;
//   * colour: jdcolor.c's YCbCr->RGB tables and RGB->Y weights.
// A file that ends early decodes as libjpeg decodes it: past the data the
// Huffman decoder reads zero bits and leaves every later MCU at zero
// (mid-gray), the arithmetic decoder reads zero bytes to the end.

#include <cstdlib>
#include <cstring>

#include "yst_codecs.h"

namespace yst {
namespace {

// zigzag -> natural order, with 16 guard entries for corrupt run lengths
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The QM coder's probability estimation (ITU T.81 Table D.2) in libjpeg's
// packing, jaritab.c: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS. Entry 113 is the fixed estimate (Qe 0x5a1d, no adaptation)
// that signs and refinement bits are coded with.
const uint32_t kQeTable[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// ------------------------------------------------------------------ tables

struct Tables {
  uint8_t idct_limit[1024];  // libjpeg's post-IDCT range limit, by (x & 1023)
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t rgb_y[768];
  Tables() {
    for (int i = 0; i < 1024; ++i)
      idct_limit[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    const int64_t half = 1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = (int32_t)(-fix(0.71414) * x);
      cb_g[i] = (int32_t)(-fix(0.34414) * x + half);
      rgb_y[i] = (int32_t)(fix(0.29900) * i);
      rgb_y[i + 256] = (int32_t)(fix(0.58700) * i);
      rgb_y[i + 512] = (int32_t)(fix(0.11400) * i + half);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// -------------------------------------------------------------------- IDCT
// Each takes one block of quantized coefficients (natural order) and its
// dequantization table and writes an NxN block of samples. The arithmetic
// is libjpeg-turbo's, names and all: CONST_BITS 13, PASS1_BITS 2.

typedef int64_t L;
constexpr int CB = 13, P1 = 2;
constexpr L fix(double x) { return (L)(x * (1 << CB) + 0.5); }
inline L dq(const int16_t* c, const int16_t* q, int i) { return (L)((int)c[i] * (int)q[i]); }
inline L descale(L x, int n) { return (x + ((L)1 << (n - 1))) >> n; }
#define OUT(v, s) lim[(int)((v) >> (s)) & 1023]

// libjpeg-turbo runs the 8x8, 4x4 and 2x2 transforms in SIMD (SSE2/AVX2),
// which agree with its C code on every coefficient a valid file holds but
// keep 16-bit lanes: the dequantized coefficient wraps to 16 bits, pass 1's
// outputs saturate to 16 bits, and the final sample saturates to
// [-128, 127] before the +128 (the C code's range limit wraps modulo 1024).
// Garbage blocks (a truncated or corrupt file) show the difference.
inline L dq16(const int16_t* c, const int16_t* q, int i) {
  return (L)(int16_t)((int)c[i] * (int)q[i]);
}
inline int sat16(L v) { return (int)(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline uint8_t sat8(L v) {
  v = sat16(v);
  return (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}

// One 8-point pass in the SIMD code's form: each product a pmaddwd of two
// 16-bit inputs against a constant pair (equal to jpeg_idct_islow's
// products), the sums in0 +- in4, in7 + in3 and in5 + in1 taken in 16 bits.
struct Islow8 {
  L e0, e1, e2, e3, o0, o1, o2, o3;  // even outputs, odd terms (tmp0..tmp3)
  Islow8(L in0, L in1, L in2, L in3, L in4, L in5, L in6, L in7) {
    L tmp2 = in2 * fix(0.541196100) + in6 * (fix(0.541196100) - fix(1.847759065));
    L tmp3 = in2 * (fix(0.541196100) + fix(0.765366865)) + in6 * fix(0.541196100);
    L tmp0 = (L)(int16_t)(in0 + in4) * (1 << CB);
    L tmp1 = (L)(int16_t)(in0 - in4) * (1 << CB);
    e0 = tmp0 + tmp3;
    e3 = tmp0 - tmp3;
    e1 = tmp1 + tmp2;
    e2 = tmp1 - tmp2;
    L z3 = (int16_t)(in7 + in3), z4 = (int16_t)(in5 + in1);
    L z3s = z3 * (fix(1.175875602) - fix(1.961570560)) + z4 * fix(1.175875602);
    L z4s = z3 * fix(1.175875602) + z4 * (fix(1.175875602) - fix(0.390180644));
    o0 = in7 * (fix(0.298631336) - fix(0.899976223)) + in1 * -fix(0.899976223) + z3s;
    o1 = in5 * (fix(2.053119869) - fix(2.562915447)) + in3 * -fix(2.562915447) + z4s;
    o2 = in5 * -fix(2.562915447) + in3 * (fix(3.072711026) - fix(2.562915447)) + z3s;
    o3 = in7 * -fix(0.899976223) + in1 * (fix(1.501321110) - fix(0.899976223)) + z4s;
  }
};

// jpeg_idct_islow as libjpeg-turbo's SSE2/AVX2 code computes it
void idct_8x8(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t*) {
  int ws[64];
  bool ac = false;  // the SIMD code tests rows 1..7 of all columns at once
  for (int i = 8; i < 64; ++i) ac = ac || in[i];
  for (int c = 0; c < 8; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    int* w = ws + c;
    if (!ac) {
      int dc = (int16_t)(dq16(p, qp, 0) * (1 << P1));
      for (int k = 0; k < 8; ++k) w[8 * k] = dc;
      continue;
    }
    Islow8 t(dq16(p, qp, 0), dq16(p, qp, 8), dq16(p, qp, 16), dq16(p, qp, 24), dq16(p, qp, 32),
             dq16(p, qp, 40), dq16(p, qp, 48), dq16(p, qp, 56));
    const int s = CB - P1;
    w[0] = sat16(descale(t.e0 + t.o3, s));
    w[56] = sat16(descale(t.e0 - t.o3, s));
    w[8] = sat16(descale(t.e1 + t.o2, s));
    w[48] = sat16(descale(t.e1 - t.o2, s));
    w[16] = sat16(descale(t.e2 + t.o1, s));
    w[40] = sat16(descale(t.e2 - t.o1, s));
    w[24] = sat16(descale(t.e3 + t.o0, s));
    w[32] = sat16(descale(t.e3 - t.o0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    Islow8 t(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]);
    const int s = CB + P1 + 3;
    o[0] = sat8(descale(t.e0 + t.o3, s));
    o[7] = sat8(descale(t.e0 - t.o3, s));
    o[1] = sat8(descale(t.e1 + t.o2, s));
    o[6] = sat8(descale(t.e1 - t.o2, s));
    o[2] = sat8(descale(t.e2 + t.o1, s));
    o[5] = sat8(descale(t.e2 - t.o1, s));
    o[3] = sat8(descale(t.e3 + t.o0, s));
    o[4] = sat8(descale(t.e3 - t.o0, s));
  }
}

inline L w32(L v) { return (L)(int32_t)(uint32_t)v; }  // a 32-bit lane's wraparound

// jidctred.c's 4x4 as libjpeg-turbo's SSE2 code computes it: the odd terms
// are two pmaddwd pairs summed in 32 bits, and every sum and rounding wraps
// at 32 bits; pass 1 saturates to 16 bits, pass 2 to a sample (sat8).
void idct_4x4(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t*) {
  // tmp2 and tmp0 of jidctred.c from inputs 1, 3, 5, 7
  auto odd = [](L x1, L x3, L x5, L x7, L* t2, L* t0) {
    *t2 = w32((x1 * fix(2.562915447) + x3 * fix(0.899976223)) +
              (x5 * -fix(0.601344887) + x7 * -fix(0.509795579)));
    *t0 = w32((x1 * fix(1.061594337) + x3 * -fix(2.172734803)) +
              (x5 * fix(1.451774981) + x7 * -fix(0.211164243)));
  };
  auto put = [](L tmp10, L tmp12, L t2, L t0, int s, L* o) {
    const L r = (L)1 << (s - 1);
    o[0] = w32(w32(tmp10 + t2) + r) >> s;
    o[3] = w32(w32(tmp10 - t2) + r) >> s;
    o[1] = w32(w32(tmp12 + t0) + r) >> s;
    o[2] = w32(w32(tmp12 - t0) + r) >> s;
  };
  int ws[32];
  bool ac = false;
  for (int i = 8; i < 64; ++i) ac = ac || (in[i] && (i >> 3) != 4);
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // column 4 is not used by the second pass
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    int* w = ws + c;
    if (!ac) {
      int dc = (int16_t)(dq16(p, qp, 0) * (1 << P1));
      for (int k = 0; k < 4; ++k) w[8 * k] = dc;
      continue;
    }
    const L tmp0 = dq16(p, qp, 0) * (1 << (CB + 1));
    const L even = dq16(p, qp, 16) * fix(1.847759065) + dq16(p, qp, 48) * -fix(0.765366865);
    L t2, t0, o[4];
    odd(dq16(p, qp, 8), dq16(p, qp, 24), dq16(p, qp, 40), dq16(p, qp, 56), &t2, &t0);
    put(w32(tmp0 + even), w32(tmp0 - even), t2, t0, CB - P1 + 1, o);
    for (int k = 0; k < 4; ++k) w[8 * k] = sat16(o[k]);
  }
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o8 = out + r * stride;
    const L tmp0 = (L)w[0] * (1 << (CB + 1));
    const L even = w[2] * fix(1.847759065) + w[6] * -fix(0.765366865);
    L t2, t0, o[4];
    odd(w[1], w[3], w[5], w[7], &t2, &t0);
    put(w32(tmp0 + even), w32(tmp0 - even), t2, t0, CB + P1 + 3 + 1, o);
    for (int k = 0; k < 4; ++k) o8[k] = sat8(o[k]);
  }
}

// jidctred.c's 2x2 as libjpeg-turbo's SSE2 code computes it: the odd terms
// are pmaddwd pairs summed in 32 bits (wrapping), column 0's pass-1 output
// stays 32 bits wide (and wraps when pass 2 shifts it) while columns 1, 3,
// 5 and 7 saturate to 16 bits, and there is no all-zero shortcut.
void idct_2x2(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t*) {
  auto odd = [](L a1, L a3, L a5, L a7) {
    return w32((a1 * fix(3.624509785) - a3 * fix(1.272758580)) +
               (a5 * fix(0.850430095) - a7 * fix(0.720959822)));
  };
  L ws[2][8];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    const L t = odd(dq16(p, qp, 8), dq16(p, qp, 24), dq16(p, qp, 40), dq16(p, qp, 56));
    const L dc = dq16(p, qp, 0) * (1 << (CB + 2));
    const int s = CB - P1 + 2;
    L a = w32(w32(dc + t) + (1 << (s - 1))) >> s, b = w32(w32(dc - t) + (1 << (s - 1))) >> s;
    ws[0][c] = c ? sat16(a) : a;
    ws[1][c] = c ? sat16(b) : b;
  }
  for (int r = 0; r < 2; ++r) {
    const L* w = ws[r];
    uint8_t* o = out + r * stride;
    const L t = odd(w[1], w[3], w[5], w[7]), t10 = w32(w[0] * (1 << (CB + 2)));
    const int s = CB + P1 + 3 + 2;
    o[0] = sat8(w32(w32(t10 + t) + (1 << (s - 1))) >> s);
    o[1] = sat8(w32(w32(t10 - t) + (1 << (s - 1))) >> s);
  }
}

void idct_1x1(const int16_t* in, const int16_t* q, uint8_t* out, size_t,
              const uint8_t* lim) {
  int dc = (int)descale(dq(in, q, 0), 3);
  out[0] = lim[dc & 1023];
}

// jidctint.c's scaled IDCTs. Pass 1 works down the columns of the first
// min(N, 8) inputs into an N-row work array, pass 2 along each row.
void idct_3x3(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t* lim) {
  int ws[9];
  for (int c = 0; c < 3; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    L tmp0 = dq(p, qp, 0) * (1 << CB) + ((L)1 << (CB - P1 - 1));
    L tmp12 = dq(p, qp, 16) * fix(0.707106781);
    L tmp10 = tmp0 + tmp12;
    L tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = dq(p, qp, 8) * fix(1.224744871);
    ws[3 * 0 + c] = (int)((tmp10 + tmp0) >> (CB - P1));
    ws[3 * 2 + c] = (int)((tmp10 - tmp0) >> (CB - P1));
    ws[3 * 1 + c] = (int)(tmp2 >> (CB - P1));
  }
  for (int r = 0; r < 3; ++r) {
    const int* w = ws + 3 * r;
    uint8_t* o = out + r * stride;
    L tmp0 = ((L)w[0] + ((L)1 << (P1 + 2))) * (1 << CB);
    L tmp12 = w[2] * fix(0.707106781);
    L tmp10 = tmp0 + tmp12;
    L tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = w[1] * fix(1.224744871);
    const int s = CB + P1 + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[2] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp2, s);
  }
}

void idct_5x5(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t* lim) {
  int ws[25];
  for (int c = 0; c < 5; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    L tmp12 = dq(p, qp, 0) * (1 << CB) + ((L)1 << (CB - P1 - 1));
    L tmp0 = dq(p, qp, 16), tmp1 = dq(p, qp, 32);
    L z1 = (tmp0 + tmp1) * fix(0.790569415);
    L z2 = (tmp0 - tmp1) * fix(0.353553391);
    L z3 = tmp12 + z2;
    L tmp10 = z3 + z1, tmp11 = z3 - z1;
    tmp12 -= z2 * 4;
    z2 = dq(p, qp, 8);
    z3 = dq(p, qp, 24);
    z1 = (z2 + z3) * fix(0.831253876);
    tmp0 = z1 + z2 * fix(0.513743148);
    tmp1 = z1 - z3 * fix(2.176250899);
    const int s = CB - P1;
    ws[5 * 0 + c] = (int)((tmp10 + tmp0) >> s);
    ws[5 * 4 + c] = (int)((tmp10 - tmp0) >> s);
    ws[5 * 1 + c] = (int)((tmp11 + tmp1) >> s);
    ws[5 * 3 + c] = (int)((tmp11 - tmp1) >> s);
    ws[5 * 2 + c] = (int)(tmp12 >> s);
  }
  for (int r = 0; r < 5; ++r) {
    const int* w = ws + 5 * r;
    uint8_t* o = out + r * stride;
    L tmp12 = ((L)w[0] + ((L)1 << (P1 + 2))) * (1 << CB);
    L tmp0 = w[2], tmp1 = w[4];
    L z1 = (tmp0 + tmp1) * fix(0.790569415);
    L z2 = (tmp0 - tmp1) * fix(0.353553391);
    L z3 = tmp12 + z2;
    L tmp10 = z3 + z1, tmp11 = z3 - z1;
    tmp12 -= z2 * 4;
    z2 = w[1];
    z3 = w[3];
    z1 = (z2 + z3) * fix(0.831253876);
    tmp0 = z1 + z2 * fix(0.513743148);
    tmp1 = z1 - z3 * fix(2.176250899);
    const int s = CB + P1 + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[4] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[3] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12, s);
  }
}

void idct_6x6(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t* lim) {
  int ws[36];
  for (int c = 0; c < 6; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    L tmp0 = dq(p, qp, 0) * (1 << CB) + ((L)1 << (CB - P1 - 1));
    L tmp10 = dq(p, qp, 32) * fix(0.707106781);
    L tmp1 = tmp0 + tmp10;
    L tmp11 = (tmp0 - tmp10 - tmp10) >> (CB - P1);
    tmp10 = dq(p, qp, 16);
    tmp0 = tmp10 * fix(1.224744871);
    tmp10 = tmp1 + tmp0;
    L tmp12 = tmp1 - tmp0;
    L z1 = dq(p, qp, 8), z2 = dq(p, qp, 24), z3 = dq(p, qp, 40);
    tmp1 = (z1 + z3) * fix(0.366025404);
    tmp0 = tmp1 + (z1 + z2) * (1 << CB);
    L tmp2 = tmp1 + (z3 - z2) * (1 << CB);
    tmp1 = (z1 - z2 - z3) * (1 << P1);
    const int s = CB - P1;
    ws[6 * 0 + c] = (int)((tmp10 + tmp0) >> s);
    ws[6 * 5 + c] = (int)((tmp10 - tmp0) >> s);
    ws[6 * 1 + c] = (int)(tmp11 + tmp1);
    ws[6 * 4 + c] = (int)(tmp11 - tmp1);
    ws[6 * 2 + c] = (int)((tmp12 + tmp2) >> s);
    ws[6 * 3 + c] = (int)((tmp12 - tmp2) >> s);
  }
  for (int r = 0; r < 6; ++r) {
    const int* w = ws + 6 * r;
    uint8_t* o = out + r * stride;
    L tmp0 = ((L)w[0] + ((L)1 << (P1 + 2))) * (1 << CB);
    L tmp10 = w[4] * fix(0.707106781);
    L tmp1 = tmp0 + tmp10;
    L tmp11 = tmp0 - tmp10 - tmp10;
    tmp10 = w[2];
    tmp0 = tmp10 * fix(1.224744871);
    tmp10 = tmp1 + tmp0;
    L tmp12 = tmp1 - tmp0;
    L z1 = w[1], z2 = w[3], z3 = w[5];
    tmp1 = (z1 + z3) * fix(0.366025404);
    tmp0 = tmp1 + (z1 + z2) * (1 << CB);
    L tmp2 = tmp1 + (z3 - z2) * (1 << CB);
    tmp1 = (z1 - z2 - z3) * (1 << CB);
    const int s = CB + P1 + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[5] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[4] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12 + tmp2, s);
    o[3] = OUT(tmp12 - tmp2, s);
  }
}

void idct_7x7(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t* lim) {
  int ws[49];
  for (int c = 0; c < 7; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    L tmp13 = dq(p, qp, 0) * (1 << CB) + ((L)1 << (CB - P1 - 1));
    L z1 = dq(p, qp, 16), z2 = dq(p, qp, 32), z3 = dq(p, qp, 48);
    L tmp10 = (z2 - z3) * fix(0.881747734);
    L tmp12 = (z1 - z2) * fix(0.314692123);
    L tmp11 = tmp10 + tmp12 + tmp13 - z2 * fix(1.841218003);
    L tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = tmp0 * fix(1.274162392) + tmp13;
    tmp10 += tmp0 - z3 * fix(0.077722536);
    tmp12 += tmp0 - z1 * fix(2.470602249);
    tmp13 += z2 * fix(1.414213562);
    z1 = dq(p, qp, 8);
    z2 = dq(p, qp, 24);
    z3 = dq(p, qp, 40);
    L tmp1 = (z1 + z2) * fix(0.935414347);
    L tmp2 = (z1 - z2) * fix(0.170262339);
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = (z2 + z3) * -fix(1.378756276);
    tmp1 += tmp2;
    z2 = (z1 + z3) * fix(0.613604268);
    tmp0 += z2;
    tmp2 += z2 + z3 * fix(1.870828693);
    const int s = CB - P1;
    ws[7 * 0 + c] = (int)((tmp10 + tmp0) >> s);
    ws[7 * 6 + c] = (int)((tmp10 - tmp0) >> s);
    ws[7 * 1 + c] = (int)((tmp11 + tmp1) >> s);
    ws[7 * 5 + c] = (int)((tmp11 - tmp1) >> s);
    ws[7 * 2 + c] = (int)((tmp12 + tmp2) >> s);
    ws[7 * 4 + c] = (int)((tmp12 - tmp2) >> s);
    ws[7 * 3 + c] = (int)(tmp13 >> s);
  }
  for (int r = 0; r < 7; ++r) {
    const int* w = ws + 7 * r;
    uint8_t* o = out + r * stride;
    L tmp13 = ((L)w[0] + ((L)1 << (P1 + 2))) * (1 << CB);
    L z1 = w[2], z2 = w[4], z3 = w[6];
    L tmp10 = (z2 - z3) * fix(0.881747734);
    L tmp12 = (z1 - z2) * fix(0.314692123);
    L tmp11 = tmp10 + tmp12 + tmp13 - z2 * fix(1.841218003);
    L tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = tmp0 * fix(1.274162392) + tmp13;
    tmp10 += tmp0 - z3 * fix(0.077722536);
    tmp12 += tmp0 - z1 * fix(2.470602249);
    tmp13 += z2 * fix(1.414213562);
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    L tmp1 = (z1 + z2) * fix(0.935414347);
    L tmp2 = (z1 - z2) * fix(0.170262339);
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = (z2 + z3) * -fix(1.378756276);
    tmp1 += tmp2;
    z2 = (z1 + z3) * fix(0.613604268);
    tmp0 += z2;
    tmp2 += z2 + z3 * fix(1.870828693);
    const int s = CB + P1 + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[6] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[5] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12 + tmp2, s);
    o[4] = OUT(tmp12 - tmp2, s);
    o[3] = OUT(tmp13, s);
  }
}

// The 10-, 12- and 14-point transforms, one column (pass 1: inputs
// dequantized, stride 8; outputs descaled to PASS1_BITS) or one row (pass
// 2: outputs the final samples). ``x(k)`` is input k; ``first`` the
// rounding-adjusted DC term.
template <class X, class Put>
void ten(X x, L first, Put put) {
  L z3 = first;
  L z4 = x(4);
  L z1 = z4 * fix(1.144122806);
  L z2 = z4 * fix(0.437016024);
  L tmp10 = z3 + z1, tmp11 = z3 - z2;
  L tmp22 = z3 - (z1 - z2) * 2;
  z2 = x(2);
  z3 = x(6);
  z1 = (z2 + z3) * fix(0.831253876);
  L tmp12 = z1 + z2 * fix(0.513743148);
  L tmp13 = z1 - z3 * fix(2.176250899);
  L tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
  L tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;
  z1 = x(1);
  z2 = x(3);
  z3 = x(5);
  z4 = x(7);
  tmp11 = z2 + z4;
  tmp13 = z2 - z4;
  tmp12 = tmp13 * fix(0.309016994);
  L z5 = z3 * (1 << CB);
  z2 = tmp11 * fix(0.951056516);
  z4 = z5 + tmp12;
  tmp10 = z1 * fix(1.396802247) + z2 + z4;
  L tmp14 = z1 * fix(0.221231742) - z2 + z4;
  z2 = tmp11 * fix(0.587785252);
  z4 = z5 - tmp12 - tmp13 * (1 << (CB - 1));
  tmp12 = (z1 - tmp13) * (1 << CB) - z5;
  tmp11 = z1 * fix(1.260073511) - z2 - z4;
  tmp13 = z1 * fix(0.642039522) - z2 + z4;
  put(0, tmp20 + tmp10);
  put(9, tmp20 - tmp10);
  put(1, tmp21 + tmp11);
  put(8, tmp21 - tmp11);
  put(2, tmp22 + tmp12);
  put(7, tmp22 - tmp12);
  put(3, tmp23 + tmp13);
  put(6, tmp23 - tmp13);
  put(4, tmp24 + tmp14);
  put(5, tmp24 - tmp14);
}

template <class X, class Put>
void twelve(X x, L first, Put put) {
  L z3 = first;
  L z4 = x(4) * fix(1.224744871);
  L tmp10 = z3 + z4, tmp11 = z3 - z4;
  L z1 = x(2);
  z4 = z1 * fix(1.366025404);
  z1 *= (1 << CB);
  L z2 = x(6) * (1 << CB);
  L tmp12 = z1 - z2;
  L tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
  tmp12 = z4 + z2;
  L tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
  tmp12 = z4 - z1 - z2;
  L tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;
  z1 = x(1);
  z2 = x(3);
  z3 = x(5);
  z4 = x(7);
  tmp11 = z2 * fix(1.306562965);
  L tmp14 = z2 * -fix(0.541196100);
  tmp10 = z1 + z3;
  L tmp15 = (tmp10 + z4) * fix(0.860918669);
  tmp12 = tmp15 + tmp10 * fix(0.261052384);
  tmp10 = tmp12 + tmp11 + z1 * fix(0.280143716);
  L tmp13 = (z3 + z4) * -fix(1.045510580);
  tmp12 += tmp13 + tmp14 - z3 * fix(1.478575242);
  tmp13 += tmp15 - tmp11 + z4 * fix(1.586706681);
  tmp15 += tmp14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
  z1 -= z4;
  z2 -= z3;
  z3 = (z1 + z2) * fix(0.541196100);
  tmp11 = z3 + z1 * fix(0.765366865);
  tmp14 = z3 - z2 * fix(1.847759065);
  put(0, tmp20 + tmp10);
  put(11, tmp20 - tmp10);
  put(1, tmp21 + tmp11);
  put(10, tmp21 - tmp11);
  put(2, tmp22 + tmp12);
  put(9, tmp22 - tmp12);
  put(3, tmp23 + tmp13);
  put(8, tmp23 - tmp13);
  put(4, tmp24 + tmp14);
  put(7, tmp24 - tmp14);
  put(5, tmp25 + tmp15);
  put(6, tmp25 - tmp15);
}

template <class X, class Put>
void fourteen(X x, L first, Put put) {
  L z1 = first;
  L z4 = x(4);
  L z2 = z4 * fix(1.274162392);
  L z3 = z4 * fix(0.314692123);
  z4 = z4 * fix(0.881747734);
  L tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
  L tmp23 = z1 - (z2 + z3 - z4) * 2;
  z1 = x(2);
  z2 = x(6);
  z3 = (z1 + z2) * fix(1.105676686);
  L tmp13 = z3 + z1 * fix(0.273079590);
  L tmp14 = z3 - z2 * fix(1.719280954);
  L tmp15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
  L tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
  L tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
  L tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;
  z1 = x(1);
  z2 = x(3);
  z3 = x(5);
  z4 = x(7) * (1 << CB);
  tmp14 = z1 + z3;
  tmp11 = (z1 + z2) * fix(1.334852607);
  tmp12 = tmp14 * fix(1.197448846);
  tmp10 = tmp11 + tmp12 + z4 - z1 * fix(1.126980169);
  tmp14 = tmp14 * fix(0.752406978);
  L tmp16 = tmp14 - z1 * fix(1.061150426);
  z1 -= z2;
  tmp15 = z1 * fix(0.467085129) - z4;
  tmp16 += tmp15;
  tmp13 = (z2 + z3) * -fix(0.158341681) - z4;
  tmp11 += tmp13 - z2 * fix(0.424103948);
  tmp12 += tmp13 - z3 * fix(2.373959773);
  tmp13 = (z3 - z2) * fix(1.405321284);
  tmp14 += tmp13 + z4 - z3 * fix(1.6906431334);
  tmp15 += tmp13 + z2 * fix(0.674957567);
  tmp13 = (z1 - z3) * (1 << CB) + z4;
  put(0, tmp20 + tmp10);
  put(13, tmp20 - tmp10);
  put(1, tmp21 + tmp11);
  put(12, tmp21 - tmp11);
  put(2, tmp22 + tmp12);
  put(11, tmp22 - tmp12);
  put(3, tmp23 + tmp13);
  put(10, tmp23 - tmp13);
  put(4, tmp24 + tmp14);
  put(9, tmp24 - tmp14);
  put(5, tmp25 + tmp15);
  put(8, tmp25 - tmp15);
  put(6, tmp26 + tmp16);
  put(7, tmp26 - tmp16);
}

template <int N, class F>
void idct_big(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
              const uint8_t* lim, F transform) {
  int ws[8 * N];
  for (int c = 0; c < 8; ++c) {
    const int16_t* p = in + c;
    const int16_t* qp = q + c;
    auto x = [&](int k) { return dq(p, qp, 8 * k); };
    L first = dq(p, qp, 0) * (1 << CB) + ((L)1 << (CB - P1 - 1));
    transform(x, first, [&](int k, L v) { ws[8 * k + c] = (int)(v >> (CB - P1)); });
  }
  for (int r = 0; r < N; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    auto x = [&](int k) { return (L)w[k]; };
    L first = ((L)w[0] + ((L)1 << (P1 + 2))) * (1 << CB);
    transform(x, first, [&](int k, L v) { o[k] = OUT(v, CB + P1 + 3); });
  }
}

void idct_10x10(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
                const uint8_t* lim) {
  idct_big<10>(in, q, out, stride, lim,
               [](auto x, L first, auto put) { ten(x, first, put); });
}
void idct_12x12(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
                const uint8_t* lim) {
  idct_big<12>(in, q, out, stride, lim,
               [](auto x, L first, auto put) { twelve(x, first, put); });
}
void idct_14x14(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride,
                const uint8_t* lim) {
  idct_big<14>(in, q, out, stride, lim,
               [](auto x, L first, auto put) { fourteen(x, first, put); });
}

typedef void (*IdctFn)(const int16_t*, const int16_t*, uint8_t*, size_t, const uint8_t*);

IdctFn idct_for(int size) {
  switch (size) {
    case 1: return idct_1x1;
    case 2: return idct_2x2;
    case 3: return idct_3x3;
    case 4: return idct_4x4;
    case 5: return idct_5x5;
    case 6: return idct_6x6;
    case 7: return idct_7x7;
    case 8: return idct_8x8;
    case 10: return idct_10x10;
    case 12: return idct_12x12;
    case 14: return idct_14x14;
    default: return nullptr;
  }
}

// ----------------------------------------------------------------- decoder

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
};

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // 8-bit lookahead: (length << 8) | value; 0 = walk
};

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks covering the image (libjpeg's width_in_blocks)
  int bw_pad, bh_pad;  // blocks stored: whole MCUs
  std::vector<int16_t> coef;
  int16_t q[64];
  uint16_t qv[64];  // the same table unwrapped (block smoothing reads it)
  bool latched = false;
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic coding's DC conditioning (0, 4, 8, 12, 16)
  int coef_bits[64];
  int prev_bits[10];  // coef_bits[0..9] before the component's latest scan
};

struct Fail {};  // thrown on any error libjpeg reports with error_exit

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // bytes past n read as libjpeg's fake EOI: FF D9 FF D9 ...
  int marker = 0;  // a marker read but not yet processed

  bool saw_soi = false, saw_sof = false, progressive = false, arith = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int W = 0, H = 0, ncomp = 0, max_h = 1, max_v = 1;
  Component comp[4];
  HuffSpec dc_spec[4], ac_spec[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  int restart_interval = 0;
  int scans = 0;
  bool multi_scan = false;
  // arithmetic-coding conditioning by table (DAC; libjpeg's defaults)
  uint8_t dac_L[16], dac_U[16], dac_K[16];
  int last_good_row = 0;  // jdcoefct.c's last_good_iMCU_row

  // the current scan
  int ns = 0;
  Component* sc[4];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  HuffTable dct[4], act[4];
  int next_restart = 0, restarts_to_go = 0, eobrun = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool insufficient = false;
  // the arithmetic decoder (jdarith.c): C and A registers, bit counter
  // (-16 before the first two bytes, -1 after a decoding error), statistics
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = 0;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;

  Decoder() {
    std::memset(dac_L, 0, sizeof(dac_L));
    std::memset(dac_U, 1, sizeof(dac_U));
    std::memset(dac_K, 5, sizeof(dac_K));
  }

  int byte_at(size_t i) const { return i < n ? d[i] : ((i - n) & 1) ? 0xD9 : 0xFF; }
  int u8() { return byte_at(pos++); }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // ---------------------------------------------------------- markers
  void next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();  // ends: past the data every other byte is FF
      do c = u8();
      while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }

  void skip_variable() {
    int len = u16() - 2;
    if (len > 0) pos += (size_t)len;
  }

  void get_dqt() {
    long len = u16() - 2;
    while (len > 0) {
      int nq = u8();
      int prec = nq >> 4;
      nq &= 15;
      if (nq >= 4) throw Fail();
      for (int i = 0; i < 64; ++i) qt[nq][kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[nq] = true;
      len -= 64 + 1;
      if (prec) len -= 64;
    }
    if (len != 0) throw Fail();
  }

  void get_dht() {
    long len = u16() - 2;
    while (len > 16) {
      int index = u8();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += bits[i] = (uint8_t)u8();
      len -= 1 + 16;
      if (count > 256 || count > len) throw Fail();
      HuffSpec spec;
      spec.defined = true;
      std::memcpy(spec.bits, bits, sizeof(bits));
      std::memset(spec.vals, 0, sizeof(spec.vals));
      for (int i = 0; i < count; ++i) spec.vals[i] = (uint8_t)u8();
      len -= count;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) throw Fail();
        ac_spec[index] = spec;
      } else {
        if (index >= 4) throw Fail();
        dc_spec[index] = spec;
      }
    }
    if (len != 0) throw Fail();
  }

  // arithmetic-coding conditioning: L and U of a DC table, Kx of an AC one
  void get_dac() {
    long len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) throw Fail();
      if (index >= 16) {
        dac_K[index - 16] = (uint8_t)val;
      } else {
        dac_L[index] = (uint8_t)(val & 15);
        dac_U[index] = (uint8_t)(val >> 4);
        if (dac_L[index] > dac_U[index]) throw Fail();
      }
    }
    if (len != 0) throw Fail();
  }

  void get_dri() {
    if (u16() != 4) throw Fail();
    restart_interval = u16();
  }

  void get_app(int m) {
    long len = u16() - 2;
    int take = len >= 14 ? 14 : len > 0 ? (int)len : 0;
    uint8_t b[14];
    for (int i = 0; i < take; ++i) b[i] = (uint8_t)u8();
    len -= take;
    if (m == 0xE0 && take >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' && b[3] == 'F' &&
        b[4] == 0)
      saw_jfif = true;
    if (m == 0xEE && take >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' && b[3] == 'b' &&
        b[4] == 'e') {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    if (len > 0) pos += (size_t)len;
  }

  void get_sof(bool prog, bool ar) {
    if (saw_sof) throw Fail();
    int len = u16();
    int precision = u8();
    H = u16();
    W = u16();
    ncomp = u8();
    len -= 8;
    if (H <= 0 || W <= 0 || ncomp <= 0) throw Fail();
    if (len != ncomp * 3) throw Fail();
    // the port decodes 1 or 3 components at 8 bits (libjpeg-turbo's 8-bit
    // build refuses other precisions; 2 and 4 components have no RGB/gray
    // conversion there)
    if (precision != 8 || (ncomp != 1 && ncomp != 3)) throw Fail();
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = u8();
    }
    progressive = prog;
    arith = ar;
    saw_sof = true;
  }

  void get_sos() {
    if (!saw_sof) throw Fail();
    int len = u16();
    ns = u8();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) throw Fail();
    for (int i = 0; i < ns; ++i) {
      int cc = u8(), t = u8();
      Component* found = nullptr;
      for (int ci = 0; ci < ncomp; ++ci)
        if (comp[ci].id == cc) {
          found = &comp[ci];
          break;
        }
      if (!found) throw Fail();
      for (int j = 0; j < i; ++j)
        if (sc[j] == found) throw Fail();
      sc[i] = found;
      found->dc_tbl = (t >> 4) & 15;
      found->ac_tbl = t & 15;
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = (a >> 4) & 15;
    Al = a & 15;
    next_restart = 0;
    ++scans;
  }

  // libjpeg's read_markers: process markers up to the next SOS (true) or
  // EOI (false)
  bool read_markers() {
    for (;;) {
      if (marker == 0) {
        if (!saw_soi) {
          if (u8() != 0xFF || u8() != 0xD8) throw Fail();
          marker = 0xD8;
        } else {
          next_marker();
        }
      }
      int m = marker;
      marker = 0;
      if (m == 0xD8) {
        if (saw_soi) throw Fail();
        saw_soi = true;
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
        get_sof(m == 0xC2 || m == 0xCA, m >= 0xC9);
      } else if (m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        throw Fail();  // lossless and hierarchical: not supported
      } else if (m == 0xDA) {
        get_sos();
        return true;
      } else if (m == 0xD9) {
        return false;
      } else if (m == 0xC4) {
        get_dht();
      } else if (m == 0xDB) {
        get_dqt();
      } else if (m == 0xDD) {
        get_dri();
      } else if (m == 0xE0 || m == 0xEE) {
        get_app(m);
      } else if (m == 0xCC) {
        get_dac();
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        skip_variable();
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // parameterless: ignored
      } else {
        throw Fail();
      }
    }
  }

  // ---------------------------------------------------------- entropy
  void build_table(const HuffSpec& spec, bool is_dc, HuffTable* t) {
    if (!spec.defined) throw Fail();
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int i = spec.bits[l];
      if (p + i > 256) throw Fail();
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int nsym = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if ((int64_t)code >= ((int64_t)1 << si)) throw Fail();
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (spec.bits[l]) {
        t->valoffset[l] = p - huffcode[p];
        p += spec.bits[l];
        t->maxcode[l] = huffcode[p - 1];
      } else {
        t->maxcode[l] = -1;
      }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    std::memcpy(t->vals, spec.vals, 256);
    std::memset(t->look, 0, sizeof(t->look));
    p = 0;
    for (int l = 1; l <= 8; ++l)
      for (int i = 1; i <= spec.bits[l]; ++i, ++p) {
        int look = huffcode[p] << (8 - l);
        for (int c = 1 << (8 - l); c > 0; --c) t->look[look++] = (uint16_t)((l << 8) | spec.vals[p]);
      }
    if (is_dc)
      for (int i = 0; i < nsym; ++i)
        if (spec.vals[i] > 15) throw Fail();
  }

  // jdhuff.c's fill_bit_buffer: data bytes up to the next marker
  void fill() {
    while (cnt <= 56) {
      if (marker) return;
      int c = u8();
      if (c == 0xFF) {
        do c = u8();
        while (c == 0xFF);
        if (c != 0) {
          marker = c;
          return;
        }
        c = 0xFF;
      }
      buf = (buf << 8) | (uint64_t)c;
      cnt += 8;
    }
  }

  int bits(int k) {  // k in 1..16
    if (cnt < k) {
      fill();
      if (cnt < k) {  // past the data: zeros, and the segment is exhausted
        insufficient = true;
        buf <<= 32;
        cnt += 32;
      }
    }
    cnt -= k;
    return (int)((buf >> cnt) & ((1u << k) - 1));
  }

  int decode(const HuffTable& t) {
    if (cnt < 8) fill();
    if (cnt >= 8) {
      uint16_t e = t.look[(buf >> (cnt - 8)) & 0xFF];
      if (e) {
        cnt -= e >> 8;
        return e & 0xFF;
      }
    }
    int l = 1;
    int32_t code = bits(1);
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      ++l;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)(~0u << s) + 1 : r; }

  // libjpeg's read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (!marker) next_marker();
    if (marker == 0xD0 + next_restart) {
      marker = 0;
    } else {
      for (;;) {
        int m = marker, action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((next_restart + 1) & 7) || m == 0xD0 + ((next_restart + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((next_restart - 1) & 7) || m == 0xD0 + ((next_restart - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    next_restart = (next_restart + 1) & 7;
  }

  void restart() {
    restarts_to_go = restart_interval;
    if (arith) {  // jdarith.c's process_restart
      read_restart_marker();
      reset_arith();
      return;
    }
    cnt = 0;
    buf = 0;
    read_restart_marker();
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    eobrun = 0;
    if (!marker) insufficient = false;
  }

  // the statistics this scan codes with, the DC predictions and the C and A
  // registers, as each arithmetic-coded scan and restart interval begins
  void reset_arith() {
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
        c->dc_pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
    }
    ar_c = 0;
    ar_a = 0;
    ar_ct = -16;  // the first decision reads two bytes into C
  }

  // ------------------------------------------------- arithmetic decoding
  // jdarith.c's arith_decode: one binary decision in the context *st. Past
  // a marker (the end of the data included) the coder reads zero bytes.
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int data = 0;
        if (!marker) {
          data = u8();
          if (data == 0xFF) {
            do data = u8();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        ar_c = (ar_c << 8) | data;
        if ((ar_ct += 8) < 0 && ++ar_ct == 0) ar_a = 0x8000;
      }
      ar_a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kQeTable[sv & 0x7F];
    const uint8_t nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // A DC difference into c->dc_pred (mod 2^16), conditioned on the last
  // difference's category. false on a magnitude overflow (the scan's data
  // is then ignored up to the next restart).
  bool arith_dc(Component* c) {
    const int tbl = c->dc_tbl;
    uint8_t* st = dc_stats[tbl] + c->dc_context;
    if (arith_decode(st) == 0) {
      c->dc_context = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << dac_L[tbl]) >> 1))
      c->dc_context = 0;
    else if (m > (int)((1L << dac_U[tbl]) >> 1))
      c->dc_context = 12 + sign * 4;
    else
      c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c->dc_pred = (c->dc_pred + v) & 0xffff;
    return true;
  }

  // AC coefficients k in [lo, hi] (zigzag), each stored << al; false on a
  // spectral or magnitude overflow
  bool arith_ac(Component* c, int16_t* blk, int lo, int hi, int al) {
    const int tbl = c->ac_tbl;
    for (int k = lo; k <= hi; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // end of block
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > hi) return false;
      }
      const int sign = arith_decode(&fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= dac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)((unsigned)v << al);
    }
    return true;
  }

  // a successive-approximation AC refinement (Figure G.10 in the QM form)
  bool arith_ac_refine(Component* c, int16_t* blk) {
    const int tbl = c->ac_tbl;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  }

  // one block of an arithmetic-coded scan; false ends the MCU (an error)
  bool arith_block(Component* c, int16_t* blk) {
    if (!progressive) {
      if (!arith_dc(c)) return false;
      blk[0] = (int16_t)c->dc_pred;
      return arith_ac(c, blk, 1, 63, 0);
    }
    if (Ss == 0 && Ah == 0) {
      if (!arith_dc(c)) return false;
      blk[0] = (int16_t)((unsigned)c->dc_pred << Al);
      return true;
    }
    if (Ss == 0) {
      if (arith_decode(&fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << Al));
      return true;
    }
    if (Ah == 0) return arith_ac(c, blk, Ss, Se, Al);
    return arith_ac_refine(c, blk);
  }

  int16_t* block(Component* c, int br, int bc) {
    return c->coef.data() + ((size_t)br * c->bw_pad + bc) * 64;
  }

  void decode_block_seq(Component* c, int16_t* blk) {
    int s = decode(dct[c->dc_tbl]);
    if (s) s = extend(bits(s), s);
    c->dc_pred += s;
    blk[0] = (int16_t)c->dc_pred;
    const HuffTable& at = act[c->ac_tbl];
    for (int k = 1; k < 64; ++k) {
      int rs = decode(at);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Component* c, int16_t* blk) {
    int s = decode(dct[c->dc_tbl]);
    if (s) s = extend(bits(s), s);
    c->dc_pred += s;
    blk[0] = (int16_t)(c->dc_pred * (1 << Al));
  }

  void decode_dc_refine(int16_t* blk) {
    if (bits(1)) blk[0] |= (int16_t)(1 << Al);
  }

  void decode_ac_first(Component* c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffTable& at = act[c->ac_tbl];
    for (int k = Ss; k <= Se; ++k) {
      int rs = decode(at);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(bits(s), s) * (1 << Al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(Component* c, int16_t* blk) {
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    const HuffTable& at = act[c->ac_tbl];
    int k = Ss;
    auto correct = [&](int16_t* coef) {
      if (bits(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = decode(at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits(1) ? p1 : m1;  // a newly nonzero coefficient is +-1 << Al
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void start_scan() {
    if (scans == 1) {
      // libjpeg's initial_setup
      if (W > 65500 || H > 65500) throw Fail();
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Fail();
        max_h = c.h > max_h ? c.h : max_h;
        max_v = c.v > max_v ? c.v : max_v;
      }
      size_t total = 0;
      int mcux = (W + 8 * max_h - 1) / (8 * max_h), mcuy = (H + 8 * max_v - 1) / (8 * max_v);
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        c.bw = (int)(((int64_t)W * c.h + 8 * max_h - 1) / (8 * max_h));
        c.bh = (int)(((int64_t)H * c.v + 8 * max_v - 1) / (8 * max_v));
        c.bw_pad = mcux * c.h;
        c.bh_pad = mcuy * c.v;
        total += (size_t)c.bw_pad * c.bh_pad;
        for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
      }
      if (total > ((size_t)1 << 24)) throw Fail();  // 2 GiB of coefficients
      for (int i = 0; i < ncomp; ++i)
        comp[i].coef.assign((size_t)comp[i].bw_pad * comp[i].bh_pad * 64, 0);
      if (!progressive) std_tables();  // jdhuff.c loads them; jdphuff.c does not
      multi_scan = progressive || ns < ncomp;
    } else if (!multi_scan) {
      throw Fail();  // a second scan in a single-scan file: EOI expected
    }
    for (int i = 0; i < ns; ++i) {  // latch quantization tables
      Component* c = sc[i];
      if (c->latched) continue;
      if (c->tq >= 4 || !qt_defined[c->tq]) throw Fail();
      for (int k = 0; k < 64; ++k) c->q[k] = (int16_t)(c->qv[k] = qt[c->tq][k]);
      c->latched = true;
    }
    if (progressive) {
      bool dc = Ss == 0;
      bool bad = dc ? Se != 0 : (Ss > Se || Se >= 64 || ns != 1);
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) throw Fail();
      for (int i = 0; i < ns; ++i) {
        // the progression status block smoothing reads: coefficients 0..9
        // as they stood before this scan, then this scan's Al
        for (int k = Ss < 1 ? Ss : 1; k <= 9; ++k)
          sc[i]->prev_bits[k] = scans > 1 ? sc[i]->coef_bits[k] : 0;
        for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
        if (arith) {
          continue;
        } else if (dc && Ah == 0) {
          if (sc[i]->dc_tbl >= 4) throw Fail();
          build_table(dc_spec[sc[i]->dc_tbl], true, &dct[sc[i]->dc_tbl]);
        } else if (!dc) {
          if (sc[i]->ac_tbl >= 4) throw Fail();
          build_table(ac_spec[sc[i]->ac_tbl], false, &act[sc[i]->ac_tbl]);
        }
      }
    } else if (!arith) {
      for (int i = 0; i < ns; ++i) {
        if (sc[i]->dc_tbl >= 4 || sc[i]->ac_tbl >= 4) throw Fail();
        build_table(dc_spec[sc[i]->dc_tbl], true, &dct[sc[i]->dc_tbl]);
        build_table(ac_spec[sc[i]->ac_tbl], false, &act[sc[i]->ac_tbl]);
      }
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw Fail();
    }
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    buf = 0;
    cnt = 0;
    insufficient = false;
    if (arith) reset_arith();
  }

  void std_tables() {
    static const uint8_t dc_bits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                           {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
    static const uint8_t ac_bits[2][17] = {
        {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
        {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
    static const uint8_t ac_vals[2][162] = {
        {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
         0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
         0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
         0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
         0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
         0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
         0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
         0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
         0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
         0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
         0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
        {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
         0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
         0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
         0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
         0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
         0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
         0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
         0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
         0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
         0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
         0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
    for (int t = 0; t < 2; ++t) {
      if (!dc_spec[t].defined) {
        HuffSpec& s = dc_spec[t];
        s.defined = true;
        std::memcpy(s.bits, dc_bits[t], 17);
        std::memset(s.vals, 0, 256);
        for (int i = 0; i < 12; ++i) s.vals[i] = (uint8_t)i;
      }
      if (!ac_spec[t].defined) {
        HuffSpec& s = ac_spec[t];
        s.defined = true;
        std::memcpy(s.bits, ac_bits[t], 17);
        std::memset(s.vals, 0, 256);
        std::memcpy(s.vals, ac_vals[t], 162);
      }
    }
  }

  void decode_scan() {
    int mcux, mcuy;
    if (ns == 1) {
      mcux = sc[0]->bw;
      mcuy = sc[0]->bh;
    } else {
      mcux = (W + 8 * max_h - 1) / (8 * max_h);
      mcuy = (H + 8 * max_v - 1) / (8 * max_v);
    }
    const bool dc = Ss == 0;
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        // jdcoefct.c: the last iMCU row whose data began before the data ran out
        if (!insufficient) last_good_row = ns == 1 ? my / sc[0]->v : my;
        if (restart_interval) {
          if (restarts_to_go == 0) restart();
        }
        if (arith ? ar_ct != -1 : !insufficient || (progressive && dc && Ah != 0)) {
          bool ok = true;
          for (int i = 0; i < ns && ok; ++i) {
            Component* c = sc[i];
            int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
            for (int y = 0; y < bh && ok; ++y)
              for (int x = 0; x < bwn && ok; ++x) {
                int16_t* blk = ns == 1 ? block(c, my, mx) : block(c, my * c->v + y, mx * c->h + x);
                if (arith)
                  ok = arith_block(c, blk);
                else if (!progressive)
                  decode_block_seq(c, blk);
                else if (dc && Ah == 0)
                  decode_dc_first(c, blk);
                else if (dc)
                  decode_dc_refine(blk);
                else if (Ah == 0)
                  decode_ac_first(c, blk);
                else
                  decode_ac_refine(c, blk);
              }
          }
          if (!ok) ar_ct = -1;
        }
        if (restart_interval) restarts_to_go--;
      }
  }

  // ------------------------------------------------------ block smoothing
  // jdcoefct.c's smoothing_ok: a progressive image whose DC is at least
  // partly known in every component, and some coefficient 1..9 (zigzag) of
  // some component not fully refined, is block-smoothed on output.
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component& c = comp[ci];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.qv[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1's 5x5 form): each
  // block's coefficients 1..9 that are still zero and not known exact are
  // estimated from the DC values of the 5x5 blocks around it, and where no
  // AC data arrived at all the DC too is interpolated; then the IDCT. The
  // neighbourhood is clamped at the image's edges as libjpeg clamps it,
  // row indices and the sliding column registers included.
  void idct_smoothed(Component& c, IdctFn idct, int ss, uint8_t* plane, size_t pw,
                     const uint8_t* lim) {
    const int total = (H + 8 * max_v - 1) / (8 * max_v);
    const int last = c.bw - 1;
    int prev_latch[10];
    for (int k = 1; k < 10; ++k) prev_latch[k] = scans > 1 ? c.prev_bits[k] : -1;
    int16_t ws[64];
    for (int by = 0; by < c.bh; ++by) {
      const int row = by / c.v, block_row = by % c.v, last_row = total - 1;
      int rows = c.v;
      if (row == last_row && c.bh % c.v) rows = c.bh % c.v;
      int rr[5];  // the block rows two above to two below, as libjpeg picks them
      rr[2] = by;
      rr[1] = block_row > 0 || row > 0 ? by - 1 : by;
      rr[0] = block_row > 1 || row > 1 ? by - 2 : rr[1];
      rr[3] = block_row < rows - 1 || row < last_row ? by + 1 : by;
      rr[4] = block_row < rows - 2 || row + 1 < last_row ? by + 2 : rr[3];
      // rows past the last good iMCU row take the previous scan's status
      const int* bits = row > last_good_row ? prev_latch : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      const int64_t Q00 = c.qv[0];
      int dc[5][5];  // [row][column], the block itself at [2][2]
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 5; ++k) dc[r][k] = block(&c, rr[r], 0)[0];
#define D(n) ((int64_t)dc[((n)-1) / 5][((n)-1) % 5])
      for (int bx = 0; bx <= last; ++bx) {
        std::memcpy(ws, block(&c, by, bx), sizeof(ws));
        if (bx == 0 && bx < last)
          for (int r = 0; r < 5; ++r) dc[r][3] = block(&c, rr[r], 1)[0];
        if (bx + 1 < last)
          for (int r = 0; r < 5; ++r) dc[r][4] = block(&c, rr[r], bx + 2)[0];
        // coefficient at zigzag index zz (natural nat) from the sum ``sum``
        auto estimate = [&](int zz, int nat, int64_t sum) {
          const int al = bits[zz];
          if (al == 0 || ws[nat] != 0) return;
          const int64_t q = c.qv[nat], num = Q00 * sum;
          int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
          if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          ws[nat] = (int16_t)(num >= 0 ? pred : -pred);
        };
        if (change_dc) {
          estimate(1, 1, -D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) +
                             3 * D(10) - 3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) -
                             3 * D(16) + 13 * D(17) - 13 * D(19) + 3 * D(20) - D(21) - D(22) +
                             D(24) + D(25));
          estimate(2, 8, -D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) +
                             38 * D(8) + 13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) -
                             13 * D(19) + D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) +
                             D(25));
          estimate(3, 16, D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) -
                              5 * D(14) + 2 * D(17) + 7 * D(18) + 2 * D(19) + D(23));
          estimate(4, 9, -D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) -
                             D(25));
          estimate(5, 2, 2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) +
                             7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19));
          estimate(6, 3, D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
          estimate(7, 10, D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
          estimate(8, 17, D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19));
          estimate(9, 24, D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
          const int64_t num =
              Q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) +
                     6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) +
                     152 * D(13) + 42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) +
                     42 * D(18) + 6 * D(19) - 6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) -
                     6 * D(24) - 2 * D(25));
          const int pred = (int)(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
          ws[0] = (int16_t)(num >= 0 ? pred : -pred);
        } else {
          estimate(1, 1, -7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15));
          estimate(2, 8, -7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23));
          estimate(3, 16, -D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23));
          estimate(4, 9, D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) -
                             D(24) + D(4) - D(6) + 10 * D(7) - 10 * D(9));
          estimate(5, 2, -D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15));
        }
        idct(ws, c.q, plane + (size_t)by * ss * pw + (size_t)bx * ss, pw, lim);
        for (int r = 0; r < 5; ++r)
          for (int k = 0; k < 4; ++k) dc[r][k] = dc[r][k + 1];
      }
#undef D
    }
  }

  // ----------------------------------------------------------- output
  uint8_t* output(int channels, int scale, int* ow, int* oh) {
    if (scale < 1 || scale > 8) throw Fail();
    const Tables& tb = tables();
    const int out_w = (int)(((int64_t)W * scale + 7) / 8);
    const int out_h = (int)(((int64_t)H * scale + 7) / 8);
    // jdcolor.c: which components the conversion reads
    bool ycc = false, rgb = false;
    if (ncomp == 3) {
      if (saw_jfif) {
        ycc = true;
      } else if (saw_adobe) {
        ycc = adobe_transform != 0;
      } else {
        ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
      }
      rgb = !ycc;
    }
    int nneed = (ncomp == 1 || (ycc && channels == 1)) ? 1 : 3;
    const bool smooth = smoothing_ok();
    std::vector<uint8_t> full[3];
    for (int ci = 0; ci < nneed; ++ci) {
      Component& c = comp[ci];
      // jdmaster.c: scale the IDCT up (by powers of 2, to 8) while the
      // sampling ratio allows, instead of upsampling
      int ss = scale;
      while (ss < 8 && (max_h * scale) % (c.h * ss * 2) == 0 &&
             (max_v * scale) % (c.v * ss * 2) == 0)
        ss *= 2;
      IdctFn idct = idct_for(ss);
      if (!idct) throw Fail();
      const int ds_w = (int)(((int64_t)W * c.h * ss + 8 * max_h - 1) / (8 * max_h));
      const int ds_h = (int)(((int64_t)H * c.v * ss + 8 * max_v - 1) / (8 * max_v));
      const size_t pw = (size_t)c.bw * ss, ph = (size_t)c.bh * ss;
      std::vector<uint8_t> plane(pw * ph);
      if (smooth)
        idct_smoothed(c, idct, ss, plane.data(), pw, tb.idct_limit);
      else
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct(block(&c, by, bx), c.q, plane.data() + (size_t)by * ss * pw + (size_t)bx * ss,
                 pw, tb.idct_limit);
      // jdsample.c
      const int h_in = c.h * ss / scale, v_in = c.v * ss / scale;
      const bool fancy = scale > 1;
      std::vector<uint8_t>& o = full[ci];
      o.resize((size_t)out_w * out_h);
      auto prow = [&](int y) { return plane.data() + (size_t)y * pw; };
      auto clamp_row = [&](int y) { return y < 0 ? 0 : y >= ds_h ? ds_h - 1 : y; };
      if (h_in == max_h && v_in == max_v) {
        for (int y = 0; y < out_h; ++y) std::memcpy(&o[(size_t)y * out_w], prow(y), out_w);
      } else if (h_in * 2 == max_h && v_in == max_v && fancy && ds_w > 2) {
        for (int y = 0; y < out_h; ++y) {
          const uint8_t* in = prow(y);
          uint8_t* dst = &o[(size_t)y * out_w];
          for (int x = 0; x < out_w; ++x) {
            int i = x >> 1, v3 = 3 * in[i];
            dst[x] = (x & 1) ? (uint8_t)((v3 + in[i + 1 < ds_w ? i + 1 : i] + 2) >> 2)
                             : (uint8_t)((v3 + in[i > 0 ? i - 1 : 0] + 1) >> 2);
          }
        }
      } else if (h_in == max_h && v_in * 2 == max_v && fancy) {
        for (int y = 0; y < out_h; ++y) {
          const uint8_t* near = prow(y >> 1);
          const uint8_t* far = prow(clamp_row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1));
          const int bias = (y & 1) ? 2 : 1;
          uint8_t* dst = &o[(size_t)y * out_w];
          for (int x = 0; x < out_w; ++x) dst[x] = (uint8_t)((3 * near[x] + far[x] + bias) >> 2);
        }
      } else if (h_in * 2 == max_h && v_in * 2 == max_v && fancy && ds_w > 2) {
        std::vector<int> sums((size_t)ds_w + 2);
        int* sum = sums.data() + 1;  // sum[-1] and sum[ds_w] repeat the edges
        for (int y = 0; y < out_h; ++y) {
          const uint8_t* near = prow(y >> 1);
          const uint8_t* far = prow(clamp_row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1));
          for (int i = 0; i < ds_w; ++i) sum[i] = 3 * near[i] + far[i];
          sum[-1] = sum[0];
          sum[ds_w] = sum[ds_w - 1];
          uint8_t* dst = &o[(size_t)y * out_w];
          for (int x = 0; x < out_w; ++x) {
            int i = x >> 1, t3 = 3 * sum[i];
            dst[x] = (x & 1) ? (uint8_t)((t3 + sum[i + 1] + 7) >> 4)
                             : (uint8_t)((t3 + sum[i - 1] + 8) >> 4);
          }
        }
      } else if (max_h % h_in == 0 && max_v % v_in == 0) {
        const int he = max_h / h_in, ve = max_v / v_in;
        for (int y = 0; y < out_h; ++y) {
          const uint8_t* in = prow(y / ve);
          for (int x = 0; x < out_w; ++x) o[(size_t)y * out_w + x] = in[x / he];
        }
      } else {
        throw Fail();  // fractional sampling ratios
      }
    }
    const size_t npx = (size_t)out_w * out_h;
    uint8_t* out = (uint8_t*)std::malloc(npx * channels);
    if (!out) throw Fail();
    if (channels == 1) {
      if (nneed == 1) {
        std::memcpy(out, full[0].data(), npx);
      } else {  // RGB -> Y
        for (size_t i = 0; i < npx; ++i)
          out[i] = (uint8_t)((tb.rgb_y[full[0][i]] + tb.rgb_y[full[1][i] + 256] +
                              tb.rgb_y[full[2][i] + 512]) >> 16);
      }
    } else if (nneed == 1) {
      for (size_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    } else if (rgb) {
      for (size_t i = 0; i < npx; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    } else {
      for (size_t i = 0; i < npx; ++i) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[3 * i] = clamp255(y + tb.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + (int)((tb.cb_g[cb] + tb.cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp255(y + tb.cb_b[cb]);
      }
    }
    *ow = out_w;
    *oh = out_h;
    return out;
  }
};

#undef OUT

}  // namespace

uint8_t* jpeg_decode(const uint8_t* data, size_t n, int channels, JpegScaleFn scale_num,
                     const void* ctx, int* w, int* h, int* ow, int* oh) {
  if (channels != 1 && channels != 3) return nullptr;
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    if (!dec.read_markers()) throw Fail();  // EOI before any scan
    do {
      dec.start_scan();
      dec.decode_scan();
    } while (dec.read_markers());
    int num = scale_num ? scale_num(dec.W, dec.H, ctx) : 8;
    uint8_t* out = dec.output(channels, num, w, h);
    *ow = dec.W;
    *oh = dec.H;
    return out;
  } catch (const Fail&) {
    return nullptr;
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

}  // namespace yst
