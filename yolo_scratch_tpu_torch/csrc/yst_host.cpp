// yst_host: the port's native host-side data pipeline: image decode,
// bilinear resize with cv2-compatible half-pixel sampling, letterbox,
// u8->f32 normalization, and a persistent pthread worker pool that prepares
// whole fixed-shape NHWC batches in one call. Bound to Python via ctypes
// (``data/native.py``).
//
// Decoding is the port's own (yst_codecs.h): PNG through yst_png.cpp and
// yst_inflate.cpp, JPEG through yst_jpeg.cpp, each giving the bytes that
// libpng's simplified API and libjpeg-turbo give. The library links no
// codec library, only the C++ runtime.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread yst_host.cpp
//        yst_inflate.cpp yst_png.cpp yst_jpeg.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include "yst_codecs.h"

namespace {

// ---------------------------------------------------------------- decoding

bool is_png(const uint8_t* d, size_t n) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  return n >= 8 && std::memcmp(d, sig, 8) == 0;
}

bool is_jpeg(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

// fit_mode for decode-time scaling hints: how the decoded image will be
// mapped onto a (tw x th) canvas downstream, which sets the minimum scale
// the decode must preserve.
enum FitMode { FIT_NONE = 0, FIT_STRETCH = 1, FIT_LETTERBOX = 2 };

struct Fit {
  int tw, th, mode;
};

// The JPEG decode-time downscale (scale_num/8): when (tw, th, fit_mode)
// request a downscale, the IDCT runs at reduced size — e.g. a 1024px JPEG
// headed for a 640px canvas decodes at 5/8 directly to 640px, skipping
// ~60% of the IDCT + the bilinear resize. The decode NEVER goes below the
// downstream target (num = ceil(8*need)), so the remaining resize is always
// a mild downscale or identity.
int scale_for(int image_w, int image_h, const void* ctx) {
  const Fit* f = (const Fit*)ctx;
  if (f->mode != FIT_NONE && f->tw > 0 && f->th > 0) {
    // required output/input ratio the decode must keep:
    //   stretch: each dim maps to the canvas independently -> the binding
    //            ratio is the LARGER per-dim ratio (never decode a dim
    //            below its target);
    //   letterbox: aspect preserved, content fits within -> the smaller.
    double rw = (double)f->tw / image_w;
    double rh = (double)f->th / image_h;
    double need = (f->mode == FIT_LETTERBOX) ? std::min(rw, rh) : std::max(rw, rh);
    if (need < 1.0) {
      int num = (int)std::ceil(need * 8.0 - 1e-9);
      return std::min(std::max(num, 1), 8);
    }
  }
  return 8;
}

// *w/*h return the DECODED dims (resize source); *ow/*oh the true original
// dims (box-unmapping metadata).
uint8_t* decode_any(const uint8_t* data, size_t size, int channels, int* w, int* h,
                    int* ow, int* oh, int tw = 0, int th = 0, int fit_mode = FIT_NONE) {
  if (is_png(data, size)) {
    uint8_t* p = yst::png_decode(data, size, channels, w, h);
    *ow = *w;
    *oh = *h;
    return p;
  }
  if (is_jpeg(data, size)) {
    Fit fit{tw, th, fit_mode};
    return yst::jpeg_decode(data, size, channels, scale_for, &fit, w, h, ow, oh);
  }
  return nullptr;
}

// ----------------------------------------------------------------- resize

// Bilinear resize, half-pixel centers (cv2.INTER_LINEAR geometry).
void resize_bilinear(const uint8_t* src, int sh, int sw, int c, uint8_t* dst, int dh,
                     int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, (size_t)sh * sw * c);
    return;
  }
  const float sx = (float)sw / dw;
  const float sy = (float)sh / dh;
  std::vector<int> x0v(dw), x1v(dw);
  std::vector<float> fxv(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = (int)std::floor(fx);
    fxv[x] = fx - x0;
    x0v[x] = std::min(std::max(x0, 0), sw - 1);
    x1v[x] = std::min(std::max(x0 + 1, 0), sw - 1);
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(std::max(y0 + 1, 0), sh - 1);
    const uint8_t* r0 = src + (size_t)y0c * sw * c;
    const uint8_t* r1 = src + (size_t)y1c * sw * c;
    uint8_t* out = dst + (size_t)y * dw * c;
    for (int x = 0; x < dw; ++x) {
      float wx = fxv[x];
      const uint8_t* p00 = r0 + (size_t)x0v[x] * c;
      const uint8_t* p01 = r0 + (size_t)x1v[x] * c;
      const uint8_t* p10 = r1 + (size_t)x0v[x] * c;
      const uint8_t* p11 = r1 + (size_t)x1v[x] * c;
      for (int k = 0; k < c; ++k) {
        float v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                  wy * ((1 - wx) * p10[k] + wx * p11[k]);
        out[(size_t)x * c + k] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// ------------------------------------------------------------- thread pool

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
          if (--outstanding_ == 0) {
            std::lock_guard<std::mutex> lk(mu_);
            done_cv_.notify_all();
          }
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> f) {
    ++outstanding_;
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return outstanding_.load() == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::atomic<int> outstanding_{0};
  bool stop_;
};

Pool* g_pool = nullptr;
int g_pool_size = 0;
std::mutex g_pool_mu;

Pool& pool(int n) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (!g_pool || g_pool_size != n) {
    delete g_pool;
    g_pool = new Pool(n);
    g_pool_size = n;
  }
  return *g_pool;
}

uint8_t* read_file(const char* path, size_t* out_size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  uint8_t* buf = (uint8_t*)std::malloc(n);
  if (buf && std::fread(buf, 1, n, f) != (size_t)n) {
    std::free(buf);
    buf = nullptr;
  }
  std::fclose(f);
  *out_size = n;
  return buf;
}

// One image, u8 end-to-end: decode -> (letterbox|stretch) resize straight
// into the caller's u8 NHWC slot. No float stage — on a single-core host
// the u8 pipeline is the throughput bound for streaming inference.
// ``fast_jpeg``: enable decode-time downscale for JPEGs (scale_for above;
// PNG has no decode-time scaling). Geometry metadata always derives from
// the TRUE original dims, so box unmapping is unaffected by the hint.
// Returns 0 ok; fills orig w/h and letterbox transform (scale, px, py).
int prepare_one_u8(const char* path, int S, int channels, int letterbox, uint8_t pad,
                   int fast_jpeg, uint8_t* out, int* ow, int* oh, float* scale,
                   int* px, int* py) {
  size_t n;
  uint8_t* bytes = read_file(path, &n);
  if (!bytes) return -1;
  int w = 0, h = 0;
  int fit = fast_jpeg ? (letterbox ? FIT_LETTERBOX : FIT_STRETCH) : FIT_NONE;
  uint8_t* img = decode_any(bytes, n, channels, &w, &h, ow, oh, S, S, fit);
  std::free(bytes);
  if (!img) return -2;

  if (letterbox) {
    // transform from TRUE original dims (what detections map back through)
    float r = std::min((float)S / *ow, (float)S / *oh);
    int nw = (int)std::lround(*ow * r), nh = (int)std::lround(*oh * r);
    nw = std::max(std::min(nw, S), 1);
    nh = std::max(std::min(nh, S), 1);
    int ox = (S - nw) / 2, oy = (S - nh) / 2;
    if (nw == S && nh == S) {
      // square source at full coverage: no padding, resize straight into
      // the slot (skips the memset + staging copy)
      resize_bilinear(img, h, w, channels, out, S, S);
    } else {
      std::memset(out, pad, (size_t)S * S * channels);
      std::vector<uint8_t> tmp((size_t)nw * nh * channels);
      resize_bilinear(img, h, w, channels, tmp.data(), nh, nw);
      for (int y = 0; y < nh; ++y)
        std::memcpy(out + ((size_t)(y + oy) * S + ox) * channels,
                    tmp.data() + (size_t)y * nw * channels, (size_t)nw * channels);
    }
    *scale = r;
    *px = ox;
    *py = oy;
  } else {
    resize_bilinear(img, h, w, channels, out, S, S);
    *scale = 0.f;
    *px = 0;
    *py = 0;
  }
  std::free(img);
  return 0;
}

// f32 variant: u8 core + one normalization pass into [0,1].
int prepare_one(const char* path, int S, int channels, int letterbox, uint8_t pad,
                int fast_jpeg, float* out, int* ow, int* oh, float* scale, int* px,
                int* py) {
  size_t total = (size_t)S * S * channels;
  std::vector<uint8_t> u8(total);
  int rc = prepare_one_u8(path, S, channels, letterbox, pad, fast_jpeg, u8.data(), ow,
                          oh, scale, px, py);
  if (rc) return rc;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < total; ++i) out[i] = u8[i] * inv;
  return 0;
}

}  // namespace

extern "C" {

// Decode a file into caller-inspectable buffer (test/debug path).
// Returns malloc'd u8 HWC buffer; caller frees with yst_free.
uint8_t* yst_decode_file(const char* path, int channels, int* w, int* h) {
  size_t n;
  uint8_t* bytes = read_file(path, &n);
  if (!bytes) return nullptr;
  int ow = 0, oh = 0;  // full decode: orig == decoded
  uint8_t* img = decode_any(bytes, n, channels, w, h, &ow, &oh);
  std::free(bytes);
  return img;
}

// Decode PNG/JPEG bytes; JPEGs at scale_num/8 (1..8; PNG ignores it).
// Returns malloc'd u8 HWC buffer (free with yst_free) or nullptr.
uint8_t* yst_decode_memory(const uint8_t* data, size_t n, int channels, int scale_num, int* w,
                           int* h) {
  int ow = 0, oh = 0;
  if (is_png(data, n)) return yst::png_decode(data, n, channels, w, h);
  if (!is_jpeg(data, n) || scale_num < 1 || scale_num > 8) return nullptr;
  return yst::jpeg_decode(
      data, n, channels, [](int, int, const void* c) { return *(const int*)c; }, &scale_num, w,
      h, &ow, &oh);
}

// Inflate one zlib stream into out[0, cap). Returns the InflateStatus
// (0 ok, 1 bad Adler-32, 2 truncated, 3 bad data, 4 out of room); *n_out
// is the number of bytes written.
int yst_inflate(const uint8_t* src, size_t n, uint8_t* out, size_t cap, size_t* n_out) {
  std::vector<uint8_t> buf;
  yst::InflateResult r = yst::zlib_inflate(src, n, &buf, cap);
  std::memcpy(out, buf.data(), buf.size());
  *n_out = buf.size();
  return (int)r.status;
}

void yst_free(uint8_t* p) { std::free(p); }

void yst_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                            int dh, int dw) {
  resize_bilinear(src, sh, sw, c, dst, dh, dw);
}

// Prepare a whole batch: out is (n, S, S, channels) float32, C-contiguous.
// meta is (n, 5) float32: [orig_w, orig_h, scale, pad_x, pad_y] per image.
// status is (n,) int32: 0 ok, negative = decode error.
// fast_jpeg != 0 enables JPEG decode-time downscale (see prepare_one_u8).
void yst_prepare_batch(const char** paths, int n, int S, int channels, int letterbox,
                       uint8_t pad_value, int nthreads, int fast_jpeg, float* out,
                       float* meta, int32_t* status) {
  Pool& p = pool(std::max(nthreads, 1));
  size_t slot = (size_t)S * S * channels;
  for (int i = 0; i < n; ++i) {
    p.submit([=] {
      int w = 0, h = 0, px = 0, py = 0;
      float sc = 0.f;
      status[i] = prepare_one(paths[i], S, channels, letterbox, pad_value, fast_jpeg,
                              out + slot * i, &w, &h, &sc, &px, &py);
      meta[i * 5 + 0] = (float)w;
      meta[i * 5 + 1] = (float)h;
      meta[i * 5 + 2] = sc;
      meta[i * 5 + 3] = (float)px;
      meta[i * 5 + 4] = (float)py;
    });
  }
  p.wait();
}

// uint8 variant: decode->resize stays u8 end-to-end (no float stage) and
// the host->device transfer is 4x smaller; the /255 cast runs fused on the
// accelerator instead.
void yst_prepare_batch_u8(const char** paths, int n, int S, int channels, int letterbox,
                          uint8_t pad_value, int nthreads, int fast_jpeg, uint8_t* out,
                          float* meta, int32_t* status) {
  Pool& p = pool(std::max(nthreads, 1));
  size_t slot = (size_t)S * S * channels;
  for (int i = 0; i < n; ++i) {
    p.submit([=] {
      int w = 0, h = 0, px = 0, py = 0;
      float sc = 0.f;
      status[i] = prepare_one_u8(paths[i], S, channels, letterbox, pad_value, fast_jpeg,
                                 out + slot * i, &w, &h, &sc, &px, &py);
      meta[i * 5 + 0] = (float)w;
      meta[i * 5 + 1] = (float)h;
      meta[i * 5 + 2] = sc;
      meta[i * 5 + 3] = (float)px;
      meta[i * 5 + 4] = (float)py;
    });
  }
  p.wait();
}

// v2: fast_jpeg param in prepare_batch*; v3: yst_decode_memory, yst_inflate
int yst_version() { return 3; }

}  // extern "C"
