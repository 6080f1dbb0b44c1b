// yst_codecs: the host library's own image codecs (no zlib, libpng or
// libjpeg). Each decoder is bounds-checked: corrupt or truncated input
// returns an error or, where libpng / libjpeg-turbo would accept it, the
// same image they would give; it never reads or writes out of bounds. The
// decoders hold no state beyond read-only tables, so the host pool's
// threads call them concurrently.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace yst {

// ---------------------------------------------------------------- inflate
// (yst_inflate.cpp: RFC 1950 zlib streams over RFC 1951 deflate)

enum InflateStatus {
  INFLATE_OK = 0,         // the stream ended and its Adler-32 matched
  INFLATE_BAD_ADLER = 1,  // the stream ended; its Adler-32 did not match
  INFLATE_TRUNCATED = 2,  // the input ran out before the stream ended
  INFLATE_BAD_DATA = 3,   // a malformed header, block or code
  INFLATE_FULL = 4,       // ``limit`` bytes were written before the end
};

struct InflateResult {
  InflateStatus status;
  size_t consumed;  // input bytes read (through the Adler-32 when it ended)
};

// Inflate the zlib stream in ``src[0, n)`` into ``out`` (cleared first),
// writing at most ``limit`` bytes: on INFLATE_FULL ``out`` holds exactly
// ``limit`` bytes and the rest of the stream is undecoded.
InflateResult zlib_inflate(const uint8_t* src, size_t n, std::vector<uint8_t>* out,
                           size_t limit);

// The Adler-32 of ``d[0, n)`` (RFC 1950).
uint32_t adler32(const uint8_t* d, size_t n);

// ------------------------------------------------------------------- PNG
// (yst_png.cpp) 8-bit gray (channels 1) or RGB (channels 3), converted as
// libpng's simplified API converts any PNG into PNG_FORMAT_GRAY / _RGB.
// Returns a malloc'd (h, w, channels) buffer, or nullptr on error.
uint8_t* png_decode(const uint8_t* data, size_t n, int channels, int* w, int* h);

// ------------------------------------------------------------------ JPEG
// (yst_jpeg.cpp) 8-bit sequential and progressive JPEGs, Huffman or
// arithmetic coded, decoded as libjpeg-turbo decodes them with
// out_color_space JCS_GRAYSCALE (channels 1) or JCS_RGB (channels 3) and
// scale_num/8 (1..8), block smoothing included. ``scale_num``
// is called once with the image's dimensions and returns the numerator.
// Returns a malloc'd buffer of the decoded (scaled) size in *w, *h and the
// image's own size in *ow, *oh; nullptr on error.
typedef int (*JpegScaleFn)(int image_w, int image_h, const void* ctx);
uint8_t* jpeg_decode(const uint8_t* data, size_t n, int channels, JpegScaleFn scale_num,
                     const void* ctx, int* w, int* h, int* ow, int* oh);

}  // namespace yst
