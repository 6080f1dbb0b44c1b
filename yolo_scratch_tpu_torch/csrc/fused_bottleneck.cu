// Fused residual bottleneck for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel yolo_scratch_tpu/ops/pallas_conv.py::
// _bneck_kernel (pallas_call at :122, entry fused_bottleneck). Bound in
// Python by yolo_scratch_tpu_torch/ops/conv_kernels.py, which also holds the
// plain PyTorch version (bottleneck_plain).
//
// What it computes (x NHWC, weights HWIO, both convs 3x3 SAME stride 1, BN
// folded into the f32 biases, every sum in f32):
//   h = silu(conv3x3(x, w1) + b1), rounded to x's type once
//   y = x + silu(conv3x3(h, w2) + b2), the residual added in f32, cast once
// conv2's SAME padding pads h with zeros: an h position outside the image is
// 0, not silu(b1 + a sum over x's zero pad).
//
// Design: one launch; a grid of (batch, tile rows, tile columns). A block
// owns a TH x TW tile of y. It loads x on the tile plus a 2-pixel halo into
// shared memory (zero outside the image), computes h on the tile plus a
// 1-pixel halo into shared memory, then conv2, the residual from the x tile
// already in shared memory, and the store. h never reaches device memory.
// Both tiles are kept with one row pitch P = TW + 4, so pixel (r, c) of a
// tile is row r*P + c of a (pixels x channels) matrix and tap (dy, dx) of a
// conv is the same matrix shifted by dy*P + dx rows: each conv is nine
// shifted (rows x K) x (K x N) products, an implicit GEMM with no im2col.
// The rows whose column lies past the tile are computed and thrown away.
// Weights are read from device memory, where they stay in L2. The tile
// shape is chosen per call (choose_plan) to fit shared memory.
//   bf16: tensor cores through nvcuda::wmma (16x16x16, bf16 in, f32 sums),
//         one warp per 32x16 block of the product; tile rows of 64 bytes or
//         more are padded by 32 bytes against bank conflicts.
//   f32:  FFMA on CUDA cores (never TF32), one thread per 4 rows x 1 column.
//
// What bounds it on this card: at the probe's shapes the operations
// (2*9*C*Ch per pixel and conv) over the tensor cores' rate; at YOLO11n's
// narrow widths (C = 16..32) the bytes of x in and y out. This first kernel
// is bound by neither (2-6% of the bound on an H100, PERF.md): the halo and
// pitch rows cost 1.5-6x the useful work, and each warp waits on L2 for its
// weight fragments (no TMA, no wgmma, no pipelining yet).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrag = 16;                       // wmma tile edge
constexpr int kRowsPerThread = 4;               // f32 path: rows per thread
constexpr int kRowPad = 16;                     // bf16 path: values added to a long tile row
constexpr size_t kDefaultSmem = 48 * 1024;      // without the opt-in attribute
constexpr size_t kTwoBlocksSmem = 113 * 1024;   // two blocks per SM fit below this

struct Plan {
  int th, tw;   // output tile
  int pitch;    // TW + 4: row pitch of the x and h tiles
  int m1, m2;   // rows conv1 (h tile) and conv2 (y tile) compute, in whole 16s
  int xrows;    // x tile rows: the last row conv1 reads is m1 - 1 + 2*pitch + 2
  int hrows;    // h tile rows, likewise for conv2
  int xld, hld; // row strides of the x and h tiles, in values
  size_t smem;  // bytes of dynamic shared memory
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

Plan make_plan(int th, int tw, int c, int ch, int esize, bool tensor_cores) {
  Plan p;
  p.th = th;
  p.tw = tw;
  p.pitch = tw + 4;
  p.m1 = round_up((th + 2) * p.pitch, kFrag);
  p.m2 = round_up(th * p.pitch, kFrag);
  p.xrows = p.m1 + 2 * p.pitch + 2;
  p.hrows = p.m1 > p.m2 + 2 * p.pitch + 2 ? p.m1 : p.m2 + 2 * p.pitch + 2;
  // A row stride of C values puts the rows of a wmma fragment in the same
  // banks when C*2 bytes is a multiple of 64; 32 more bytes spread them over
  // the banks (and keep wmma's 256-bit alignment). A 32-byte row (C = 16) is
  // spread already. The f32 path reads one row per warp at a time.
  auto ld = [&](int k) { return tensor_cores && k % 32 == 0 ? k + kRowPad : k; };
  p.xld = ld(c);
  p.hld = ld(ch);
  p.smem = (static_cast<size_t>(p.xrows) * p.xld + static_cast<size_t>(p.hrows) * p.hld) * esize +
           (tensor_cores ? kWarps * kFrag * kFrag * sizeof(float) : 0);
  return p;
}

// The tile with the fewest computed rows over the image (halo and pitch
// rows included) among those whose shared memory lets two blocks share an
// SM; failing that, among those that fit one block's limit.
bool choose_plan(int h, int w, int c, int ch, int esize, bool tensor_cores, size_t max_smem,
                 Plan* out) {
  const int tws[] = {28, 12, 4};
  const int ths[] = {16, 8, 4, 2, 1};
  const size_t limits[] = {kTwoBlocksSmem < max_smem ? kTwoBlocksSmem : max_smem, max_smem};
  for (size_t limit : limits) {
    bool found = false;
    long best = 0;
    for (int tw : tws) {
      for (int th : ths) {
        const Plan p = make_plan(th, tw, c, ch, esize, tensor_cores);
        if (p.smem > limit) continue;
        const long work = static_cast<long>(cdiv(h, th)) * cdiv(w, tw) * (p.m1 + p.m2);
        if (!found || work < best) {
          *out = p;
          best = work;
          found = true;
        }
      }
    }
    if (found) return true;
  }
  return false;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// out[m][n] = sum over taps t = 3*dy + dx and k < k_in of
//   in[(m + dy*pitch + dx) * ld + k] * w[(t * k_in + k) * n_out + n]
// for m < rows, handed to epi(m, n, sum). f32 path: each thread sums
// kRowsPerThread rows of one column; a warp's threads take neighbouring
// columns, so weight loads coalesce and tile loads broadcast.
template <typename T, typename Epi>
__device__ void conv_cuda_cores(const T* in, int ld, const T* __restrict__ w, int rows, int k_in,
                                int n_out, int pitch, Epi epi) {
  const int items = rows / kRowsPerThread * n_out;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int n = item % n_out;
    const int m0 = item / n_out * kRowsPerThread;
    float acc[kRowsPerThread] = {};
    for (int t = 0; t < 9; ++t) {
      const T* a = in + (m0 + (t / 3) * pitch + t % 3) * ld;
      const T* wt = w + static_cast<size_t>(t) * k_in * n_out + n;
      for (int k = 0; k < k_in; ++k) {
        const float wv = to_f(wt[static_cast<size_t>(k) * n_out]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf(to_f(a[i * ld + k]), wv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) epi(m0 + i, n, acc[i]);
  }
}

// The same product on tensor cores (bf16): one warp per (32 rows x 16
// columns) unit, two accumulators sharing each weight fragment. Fragments
// are staged through a per-warp 16x16 f32 scratch for the epilogue.
template <typename Epi>
__device__ void conv_tensor_cores(const bf16* in, int ld, const bf16* __restrict__ w, int rows,
                                  int k_in, int n_out, int pitch, float* scratch, Epi epi) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mtiles = rows / kFrag, ntiles = n_out / kFrag;
  const int units = cdiv(mtiles, 2) * ntiles;
  float* sc = scratch + warp * kFrag * kFrag;
  for (int unit = warp; unit < units; unit += kWarps) {
    const int nt = unit % ntiles, mt = unit / ntiles * 2;
    const bool two = mt + 1 < mtiles;  // uniform over the warp
    wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int t = 0; t < 9; ++t) {
      const bf16* a0 = in + (mt * kFrag + (t / 3) * pitch + t % 3) * ld;
      const bf16* wt = w + static_cast<size_t>(t) * k_in * n_out + nt * kFrag;
#pragma unroll 4
      for (int k = 0; k < k_in; k += kFrag) {
        wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> b;
        wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(b, wt + static_cast<size_t>(k) * n_out, n_out);
        wmma::load_matrix_sync(a, a0 + k, ld);
        wmma::mma_sync(acc[0], a, b, acc[0]);
        if (two) {
          wmma::load_matrix_sync(a, a0 + kFrag * ld + k, ld);
          wmma::mma_sync(acc[1], a, b, acc[1]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (f == 1 && !two) break;
      wmma::store_matrix_sync(sc, acc[f], kFrag, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kFrag * kFrag; e += 32)
        epi((mt + f) * kFrag + e / kFrag, nt * kFrag + e % kFrag, sc[e]);
      __syncwarp();
    }
  }
}

template <typename T, bool kTensorCores>
__global__ void __launch_bounds__(kThreads)
    fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                            const float* __restrict__ b1, const T* __restrict__ w2,
                            const float* __restrict__ b2, T* __restrict__ y, int H, int W, int C,
                            int Ch, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* hs = xs + static_cast<size_t>(p.xrows) * p.xld;
  float* scratch = reinterpret_cast<float*>(hs + static_cast<size_t>(p.hrows) * p.hld);
  const int b = blockIdx.x, y0 = blockIdx.y * p.th, x0 = blockIdx.z * p.tw;

  // x tile: row r is image pixel (y0 - 2 + r / P, x0 - 2 + r % P); zero
  // outside the image and past the tile's TH + 4 rows. 16-byte copies.
  const int vec = C * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < p.xrows * vec; i += blockDim.x) {
    const int r = i / vec, v = i % vec;
    const int ty = r / p.pitch, iy = y0 - 2 + ty, ix = x0 - 2 + r % p.pitch;
    int4 val = make_int4(0, 0, 0, 0);
    if (ty < p.th + 4 && iy >= 0 && iy < H && ix >= 0 && ix < W)
      val = reinterpret_cast<const int4*>(x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C)[v];
    reinterpret_cast<int4*>(xs + r * p.xld)[v] = val;
  }
  // h rows past what conv1 writes feed only discarded outputs; keep them 0
  for (int i = p.m1 * p.hld + threadIdx.x; i < p.hrows * p.hld; i += blockDim.x)
    hs[i] = from_f<T>(0.0f);
  __syncthreads();

  // conv1 -> h. Row m is image pixel (y0 - 1 + m / P, x0 - 1 + m % P); an h
  // position outside the image (or past the tile) is conv2's zero pad.
  auto h_out = [&](int m, int n, float acc) {
    const int hy = m / p.pitch, hx = m % p.pitch;
    const int iy = y0 - 1 + hy, ix = x0 - 1 + hx;
    const bool inside = hy < p.th + 2 && hx < p.tw + 2 && iy >= 0 && iy < H && ix >= 0 && ix < W;
    hs[m * p.hld + n] = from_f<T>(inside ? silu(acc + b1[n]) : 0.0f);
  };
  // conv2 -> y. Row m is image pixel (y0 + m / P, x0 + m % P); its residual
  // is x tile row m + 2*P + 2.
  auto y_out = [&](int m, int n, float acc) {
    const int oy = m / p.pitch, ox = m % p.pitch;
    const int iy = y0 + oy, ix = x0 + ox;
    if (oy < p.th && ox < p.tw && iy < H && ix < W) {
      const float res = to_f(xs[(m + 2 * p.pitch + 2) * p.xld + n]);
      y[((static_cast<size_t>(b) * H + iy) * W + ix) * C + n] = from_f<T>(res + silu(acc + b2[n]));
    }
  };

  if constexpr (kTensorCores) {
    conv_tensor_cores(xs, p.xld, w1, p.m1, C, Ch, p.pitch, scratch, h_out);
    __syncthreads();
    conv_tensor_cores(hs, p.hld, w2, p.m2, Ch, C, p.pitch, scratch, y_out);
  } else {
    conv_cuda_cores(xs, p.xld, w1, p.m1, C, Ch, p.pitch, h_out);
    __syncthreads();
    conv_cuda_cores(hs, p.hld, w2, p.m2, Ch, C, p.pitch, y_out);
  }
}

size_t max_smem_optin() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess)
    return 0;
  return static_cast<size_t>(optin);
}

template <typename T, bool kTensorCores>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* y, int batch, int h, int w, int c, int ch, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || ch <= 0 || c % kFrag || ch % kFrag)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!choose_plan(h, w, c, ch, sizeof(T), kTensorCores, max_smem_optin(), &p))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_bottleneck_kernel<T, kTensorCores>;
  if (p.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, cdiv(h, p.th), cdiv(w, p.tw));
  kernel<<<grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(y), h, w, c, ch, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y (batch, h, w, c) NHWC; w1 (3, 3, c, ch), w2 (3, 3, ch, c) HWIO, all
// contiguous, in x's type (x and y 16-byte aligned, weights 32-byte
// aligned); b1 (ch,), b2 (c,) f32. c and ch are multiples of 16. Returns the
// cudaError_t of the launch (0 on success).
int yst_fused_bottleneck_bf16(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, void* y, int batch, int h, int w, int c, int ch,
                              void* stream) {
  return launch<bf16, true>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, stream);
}

int yst_fused_bottleneck_f32(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, void* y, int batch, int h, int w, int c, int ch,
                             void* stream) {
  return launch<float, false>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, stream);
}

}  // extern "C"
