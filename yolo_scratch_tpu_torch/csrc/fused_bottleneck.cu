// Fused residual bottleneck for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel yolo_scratch_tpu/ops/pallas_conv.py::
// _bneck_kernel (pallas_call at :122, entry fused_bottleneck). Bound in
// Python by yolo_scratch_tpu_torch/ops/conv_kernels.py, which also holds the
// plain PyTorch version (bottleneck_plain), the weight reorder both paths
// read (weights_ohwi) and the f32 path's tf32 split of it (tf32_split).
//
// What it computes (x NHWC, both convs 3x3 SAME stride 1, BN folded into the
// f32 biases, every sum in f32):
//   h = silu(conv3x3(x, w1) + b1), rounded to x's type once
//   y = x + silu(conv3x3(h, w2) + b2), the residual added in f32, cast once
// conv2's SAME padding pads h with zeros: an h position outside the image is
// 0, not silu(b1 + a sum over x's zero pad).
//
// Both paths: one launch; a grid of (batch, tile rows, tile columns). A block
// owns a TH x TW tile of y. It loads x on the tile plus a 2-pixel halo into
// shared memory (zero outside the image), computes h on the tile plus a
// 1-pixel halo into shared memory, then conv2, the residual from the x tile
// already in shared memory, and the store. h never reaches device memory.
// The tile shape is chosen per call to fit shared memory.
//
// What bounds it on this card: at C >= 64 the operations (2*9*C*Ch per
// pixel and conv) over the tensor cores' rate; at YOLO11n's narrow widths
// (C = 16..32) the bytes of x in and y out.
//
// bf16 path (fused_bottleneck_kernel_bf16): two warpgroups issue Hopper's
// wgmma (m64nNk16, A from registers, B from shared memory, f32 sums).
// Against the causes that held the first (wmma) version to 2-7% of that
// bound:
//   1. Pitch and halo rows. Both tiles are pixel-major, unswizzled, each
//      pixel's row padded by 16 bytes (conflict-free ldmatrix). conv1's M is
//      the (TH+2)(TW+2) h pixels and conv2's the TH*TW y pixels, each padded
//      only to 64. Each lane of an ldmatrix.x4 gives the address of its own
//      pixel's neighbour for the tap, so no row of a shared pitch is
//      computed and thrown away.
//   2. Weights from L2, fragment by fragment. The wrapper reorders each
//      weight to (N, 3, 3, K), so a column's 9K values are contiguous. The
//      block copies stages of 48 or 64 K-rows x N/pass columns into shared
//      memory with cp.async, three buffers deep, in wgmma's K-major
//      no-swizzle core-matrix layout. Both warpgroups read each stage
//      through one descriptor, each for up to 2..8 blocks of 64 rows.
//   3. Small products. wgmma m64nN (N = 16..128 a pass) replaces wmma's
//      16x16x16. A stage's A fragments and descriptors are ready before
//      wgmma.fence, and its wgmmas are waited for only before the next
//      stage's ldmatrix, so the barrier and the next stage's copies run
//      under them.
//   4. Epilogue through scratch. The epilogues run from the accumulator
//      registers (wgmma's layout gives each thread its rows and column
//      pairs): conv1 writes silu(acc + b1) to the h tile as bf16 pairs,
//      conv2 stores x + silu(acc + b2) as bf16 pairs; the biases sit in
//      shared memory.
// What bounds it now, on an H100: at C >= 128 the weight stream from L2
// (every block reads both weights once per round of rows, and the tile
// that fits shared memory shrinks as C grows); at C <= 64 the epilogue and
// the ldmatrix traffic. Not done: TMA, warp specialisation, persistent
// blocks, clusters sharing a weight stage.
//
// f32 path (fused_bottleneck_kernel_3xtf32<NB, S>): the same TPU kernel in
// f32, as the JAX package's tests run it, held to rtol = atol = 1e-5. The
// bf16 path's structure on wgmma's TF32 products, made f32-accurate by error
// compensation (3xTF32). Its operations bound it at three TF32 products
// each, 3 * 2*9*C*Ch per pixel and conv over 495 TFLOP/s (0.732 ms at B=32
// on 80^2 x 128 and on 20^2 x 512; FFMA on the CUDA cores would be bound at
// 1.803 ms by 67 TFLOP/s). Against what held the FFMA kernel it replaces to
// 3% of that bound (CUDA cores only, a loop bound by scalar loads with no
// weight reuse, pitch rows, nothing asynchronous):
//   1. 3xTF32. A value v splits into hi = tf32(v) and lo = tf32(v - hi),
//      both rounded to nearest with ties away (cvt.rna.tf32.f32; the
//      wrapper splits the weights alike with integer bit operations). Per
//      k8 step the block issues wgmma m64nNk8 tf32 three times into one
//      accumulator, small terms first: a_lo*b_hi, a_hi*b_lo, a_hi*b_hi.
//      Error budget: |v - hi - lo| <= 2^-22 |v|; the dropped a_lo*b_lo is
//      <= 2^-22 |ab|; a product of two tf32 values is exact in the tensor
//      core. So each product is within ~2^-21 of f32's, and a conv's sum
//      within ~1e-6 at these scales. One TF32 pass (2^-11 a product), or
//      either correction term dropped (2^-12), is off by ~1e-4: ten times
//      the tolerance, which the f32 tests therefore guard.
//   2. Sums promoted each stage. The tensor cores' f32 accumulation does
//      not round to nearest: with one accumulator over a whole conv the
//      kernel read 1.0e-4 from the plain version at C = 512 and 2.6e-5 at C
//      = 128 on an H100. So each stage's first wgmma starts from zero
//      (scale-d = 0), and after the stage's wait its sums are added into
//      running f32 sums in registers: at most 3 * S wgmmas accumulate in
//      the tensor cores.
//   3. Weights (B): the wrapper reorders each to OHWI, then into wgmma's
//      K-major no-swizzle core matrices (8 columns x 4 values, 128 bytes)
//      in order (tf32 is K-major on both sides), and splits it into tf32 hi
//      and lo. Stages of S k8 steps (16 or 32 K') x 2*NB columns of both
//      pass through the bf16 path's three-deep cp.async ring; each 8
//      columns' slice of a stage is one contiguous run in device memory and
//      in the buffer (with the bf16 path's OHWI rows, 64-byte pieces 9K * 4
//      bytes apart, 20^2 x 512 took 27.2 ms against 16.8). Both warpgroups
//      take the same 64-row blocks, each NB of the stage's columns, so a
//      tile of one block of rows (C = 512) keeps both busy.
//   4. Activations (A) from registers: both tiles pixel-major f32, each
//      pixel's row padded by 16 bytes, conv1's M (TH+2)(TW+2) and conv2's
//      TH*TW each padded only to 64, each lane's ldmatrix.x4 address its own
//      pixel's neighbour for the tap. ldmatrix's b16 pairs are tf32's
//      m64nNk8 A fragment; two cvt.rna a value split it in registers. A
//      stage lies within one tap (8 * S divides K), so its tap offset is
//      computed per stage, with no table.
//   5. Epilogues from the running sums, with the exact SiLU (silu_fast is
//      2.5e-4 |v| off, 25x the tolerance): conv1 writes f32 h, 0 outside
//      the image; conv2 adds the residual from the f32 x tile.
//   6. Tile, NB and S per call, within one block's shared memory, by a cycle
//      model fitted to this kernel's times. At C = 128 an 8 x 10 tile with
//      NB = 64, S = 2 (x 88.7 KB, h 63.4 KB, ring 48 KB): 1.6 computed rows
//      an output a conv. At C = 512 a 3 x 4 tile (x 115.6 KB, h 61.9 KB):
//      5.3 rows an output, the limit of one block's shared memory.
// What bounds it now, on an H100: the weight stream from L2. Every block
// reads both weights' hi and lo, four times the bf16 path's bytes, once a
// conv, for the few outputs its shared memory holds (6.0 GB a call at 80^2
// x 128, 42 GB at 20^2 x 512, drawn at ~1.6 and ~2.5 TB/s). Tried and
// measured: the split in integer operations (7% faster, but a NaN whose
// payload carries into the sign bit becomes -0), a four-deep ring and
// loading the next stage's fragments under the current stage's wgmmas (no
// faster). Not done: h's channels split across a thread-block cluster, TMA
// multicast of the weight stages, warp specialisation, persistent blocks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr size_t kDefaultSmem = 48 * 1024;  // without the opt-in attribute

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// The bf16 path's SiLU, v * sigmoid(v) = v/2 * (1 + tanh(v/2)), on one MUFU
// op: tanh.approx.f32 is within 2^-11 of tanh, so this is within 2.5e-4 *
// |v| of SiLU, far inside the bf16 tolerance the kernel is held to
__device__ __forceinline__ float silu_fast(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
  return 0.5f * v * (1.0f + t);
}

int device_attr(cudaDeviceAttr attr) {
  int device = 0, value = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, device) != cudaSuccess)
    return 0;
  return value;
}

// ----------------------------------------------------------------- bf16 path

constexpr int kWarpgroups = 2;
constexpr int kTcThreads = 128 * kWarpgroups;
constexpr int kStageK = 64;  // K'-rows of a weight stage, at most (48 when 64 does not divide 9K)
constexpr int kRing = 3;     // weight stage buffers: one being loaded, two read by wgmma
constexpr int kPixPad = 8;   // bf16 values (16 bytes) after each tile pixel's row

// 64-row blocks a warpgroup holds at nb columns a pass (their f32 sums take
// 128 registers a thread at nb >= 32, 64 at nb = 16)
__host__ __device__ constexpr int blocks_per_warpgroup(int nb) {
  return nb >= 128 ? 2 : nb >= 32 ? 4 : 8;
}

struct TilePlan {
  int th, tw;    // output tile
  int xw, hw;    // pixel widths of the x tile (TW + 4) and the h tile (TW + 2)
  int m1, m2;    // h pixels (TH + 2)(TW + 2), y pixels TH * TW
  int xld, hld;  // values a tile pixel's row takes: C + 8, Ch + 8
  int h_off;     // byte offsets of the h tile, the weight stages and the
  int w_off;     // tap table (the biases follow it)
  int t_off;
  int stage;     // bytes of one weight stage
  size_t smem;   // bytes of dynamic shared memory
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 fills the rest with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's N newest cp.async groups have landed, and are
// visible to wgmma (async proxy)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\nfence.proxy.async.shared::cta;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// wgmma.fence, with the descriptors d computed before it: ptxas serialises
// the wgmmas when anything but a wgmma defines their inputs after the fence
template <int S>
__device__ __forceinline__ void wgmma_fence(const uint64_t (&d)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) asm volatile("" ::"l"(d[i]));
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to r across the asm around it
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a K-major, unswizzled B tile: core matrices of 8
// columns x 16 bytes (8 K values), 128 contiguous bytes each; the next core
// matrix along K 128 bytes on (LBO), the next 8 columns `sbo` bytes on (SBO).
// Fields (cute/atom/mma_traits_sm90_gmma.hpp, GmmaDescriptor): start address
// >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, layout 0 (no
// swizzle) in 62-63.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// d += A (64 x 16, this thread's fragment in a) * B (16 x N, descriptor):
// wgmma.mma_async m64nNk16, bf16 in, f32 sums, A from registers, B K-major.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The wgmmas of one weight stage (S k16 steps) for a warpgroup's first V
// 64-row blocks: every A fragment (ldmatrix, each lane its pixel's
// neighbour for the step's tap, tap_off[step] bytes on from its pixel) and
// descriptor is ready before the fence, then S * V wgmmas and one commit.
// The caller waits before it reuses the registers or the stage. V and S are
// compile-time, so no wgmma sits in a branch.
template <int NB, int V, int S, int MBW>
__device__ __forceinline__ void mma_stage(float (&acc)[MBW][NB / 2], const int (&row_off)[MBW],
                                          uint32_t a_addr, const int* tap_off, uint32_t b_addr) {
  uint32_t a[S][V][4];
  uint64_t desc[S];
#pragma unroll
  for (int step = 0; step < S; ++step) {
    const uint32_t off = a_addr + tap_off[step];
#pragma unroll
    for (int i = 0; i < V; ++i) ldmatrix_x4(a[step][i], off + row_off[i]);
    desc[step] = b_desc(b_addr + step * 256, S * 256);
  }
  wgmma_fence(desc);
#pragma unroll
  for (int step = 0; step < S; ++step) {
#pragma unroll
    for (int i = 0; i < V; ++i) wgmma<NB>(acc[i], a[step][i], desc[step]);
  }
  wgmma_commit();
}

// mma_stage for the warpgroup's nvalid (1..V) blocks
template <int NB, int V, int S, int MBW>
__device__ __forceinline__ void mma_stage_n(int nvalid, float (&acc)[MBW][NB / 2],
                                            const int (&row_off)[MBW], uint32_t a_addr,
                                            const int* tap_off, uint32_t b_addr) {
  if constexpr (V > 1) {
    if (nvalid < V) {
      mma_stage_n<NB, V - 1, S>(nvalid, acc, row_off, a_addr, tap_off, b_addr);
      return;
    }
  }
  mma_stage<NB, V, S>(acc, row_off, a_addr, tap_off, b_addr);
}

// One 3x3 conv of the block's tile as an implicit GEMM on wgmma:
//   out[m][n] = sum over t < 9, k < K of in[pix(m) + tap(t)][k] * w[n][t][k]
// for output pixel m < M of a grid out_w wide, whose pixel in the input tile
// (in_w wide, ld values a pixel) is pix(m) = (m / out_w) * in_w + m % out_w,
// and tap(t) = (t / 3) * in_w + t % 3. w is (N, 9, K): column n's 9K values
// (K' below) are contiguous, so a stage is a run of S * 16 K' for NB
// columns (S = 4 where 64 divides K, else 3: either divides 9K), and a k16
// step lies within one tap (K is a multiple of 16). Rows past M repeat row
// M - 1; sums go to epi(m, n, v[n], v[n + 1]).
//
// Loop: for each NB-column pass, each round of kWarpgroups * kMbw 64-row
// blocks, each stage: wait for the stage and pass the barrier, start
// loading stage + 1 into the buffer of stage - 2 (cp.async), wait for the
// previous stage's wgmmas (so the barrier, the loads and the index work
// overlap them), and issue this stage's. A round's epilogue runs after the
// wait that ends it.
template <int NB, int S, typename Epi>
__device__ __forceinline__ void conv_wgmma(const bf16* tile, int ld, int in_w, int out_w, int M,
                                           int K, int N, const bf16* __restrict__ w, bf16* stages,
                                           int stage_bytes, int* tap_off, Epi epi) {
  static_assert(kRing == 3, "the loop loads one stage ahead into the buffer of stage - 2");
  constexpr int kMbw = blocks_per_warpgroup(NB);
  constexpr int kGroups = S * 2;  // 16-byte groups of a column in a stage
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int kk = 9 * K;                                 // K' of one column
  const int nstage = kk / (S * 16);
  const int mblocks = cdiv(M, 64);
  const int nround = cdiv(mblocks, kWarpgroups * kMbw);
  const int total = N / NB * nround * nstage;
  const uint32_t a_addr = smem_addr(tile) + (lane / 16) * 16, stage_addr = smem_addr(stages);

  // byte offset from a pixel's row to its neighbour's channels for each k16
  // step; read after the loop's first barrier
  for (int q = tid; q < kk / 16; q += kTcThreads) {
    const int t = q * 16 / K, k = q * 16 - t * K;
    tap_off[q] = (((t / 3) * in_w + t % 3) * ld + k) * 2;
  }

  // stage `loaded` (K' [ls * S * 16, +S * 16) of columns [lnp * NB, +NB))
  // into buffer loaded % kRing; core matrix (n / 8, g) at byte (n / 8 *
  // kGroups + g) * 128. One cp.async group per call; past the last stage an
  // empty one.
  int loaded = 0, ls = 0, lround = 0, lnp = 0;
  auto load_next = [&]() {
    if (loaded < total) {
      const uint32_t dst = stage_addr + (loaded % kRing) * stage_bytes;
      const bf16* src = w + static_cast<size_t>(lnp) * NB * kk + ls * S * 16;
      for (int i = tid; i < NB * kGroups; i += kTcThreads) {
        const int n = i / kGroups, g = i % kGroups;
        cp_async16(dst + ((n / 8) * kGroups + g) * 128 + (n % 8) * 16,
                   src + static_cast<size_t>(n) * kk + g * 8, 16);
      }
      if (++ls == nstage) {
        ls = 0;
        if (++lround == nround) lround = 0, ++lnp;
      }
    }
    cp_async_commit();
    ++loaded;
  };

  float acc[kMbw][NB / 2];
  int row_off[kMbw];  // byte offset in the tile of this lane's A row pixel, per block
  int s = 0, round = 0, np = 0;       // the stage about to be issued
  int nvalid = 0, mb0 = 0, n0 = 0;     // the round in the registers: blocks, first block, column

  // accumulator layout: d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h,
  // column 8j + 2 * (lane % 4) + e of the 64 x NB block
  auto epilogue = [&]() {
#pragma unroll
    for (int i = 0; i < kMbw; ++i) fence_regs(acc[i]);
#pragma unroll
    for (int i = 0; i < kMbw; ++i) {
      if (i >= nvalid) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mb0 + i) * 64 + warp * 16 + lane / 4 + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
          epi(m, n0 + 8 * j + 2 * (lane % 4), acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
      }
    }
  };

  load_next();
  for (int idx = 0; idx < total; ++idx) {
    cp_async_wait<0>();
    __syncthreads();  // stage idx landed for all; all are done with stage idx - 2's buffer
    load_next();      // stage idx + 1
    wgmma_wait<0>();  // stage idx - 1's wgmmas: their registers are free
    if (s == 0) {
      if (idx > 0) epilogue();  // of the round that stage idx - 1 ended
      mb0 = (round * kWarpgroups + wg) * kMbw;  // this warpgroup's first block
      nvalid = max(0, min(kMbw, mblocks - mb0));
      n0 = np * NB;
#pragma unroll
      for (int i = 0; i < kMbw; ++i) {
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) acc[i][j] = 0.0f;
        fence_regs(acc[i]);
        const int row = min((mb0 + i) * 64 + warp * 16 + lane % 16, M - 1);
        row_off[i] = ((row / out_w) * in_w + row % out_w) * ld * 2;
      }
    }
    if (nvalid > 0)
      mma_stage_n<NB, kMbw, S>(nvalid, acc, row_off, a_addr, tap_off + s * S,
                               stage_addr + (idx % kRing) * stage_bytes);
    if (++s == nstage) {
      s = 0;
      if (++round == nround) round = 0, ++np;
    }
  }
  wgmma_wait<0>();
  epilogue();  // of the last round
}

// conv_wgmma with its steps per stage: 4 where 64 divides K, else 3
template <int NB, typename Epi>
__device__ __forceinline__ void conv_wgmma_k(const bf16* tile, int ld, int in_w, int out_w,
                                             int M, int K, int N, const bf16* __restrict__ w,
                                             bf16* stages, int stage_bytes, int* tap_off,
                                             Epi epi) {
  if (K % 64 == 0)
    conv_wgmma<NB, 4>(tile, ld, in_w, out_w, M, K, N, w, stages, stage_bytes, tap_off, epi);
  else
    conv_wgmma<NB, 3>(tile, ld, in_w, out_w, M, K, N, w, stages, stage_bytes, tap_off, epi);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_bottleneck_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                                 const float* __restrict__ b2, bf16* __restrict__ y, int H, int W,
                                 int C, int Ch, TilePlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + p.h_off);
  bf16* stages = reinterpret_cast<bf16*>(smem + p.w_off);
  int* tap_off = reinterpret_cast<int*>(smem + p.t_off);
  float* bs1 = reinterpret_cast<float*>(tap_off + 9 * (C > Ch ? C : Ch) / 16);  // biases
  float* bs2 = bs1 + Ch;
  for (int i = threadIdx.x; i < Ch; i += kTcThreads) bs1[i] = b1[i];
  for (int i = threadIdx.x; i < C; i += kTcThreads) bs2[i] = b2[i];
  const int b = blockIdx.x, y0 = blockIdx.y * p.th, x0 = blockIdx.z * p.tw;

  // x tile: pixel r is image pixel (y0 - 2 + r / xw, x0 - 2 + r % xw), zero
  // outside the image. cp.async, committed with conv1's first weight stage.
  const int vec = C / 8;
  const uint32_t xs_addr = smem_addr(xs);
  for (int i = threadIdx.x; i < (p.th + 4) * p.xw * vec; i += kTcThreads) {
    const int r = i / vec, v = i % vec;
    const int iy = y0 - 2 + r / p.xw, ix = x0 - 2 + r % p.xw;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const bf16* src = inside ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + v * 8 : x;
    cp_async16(xs_addr + (r * p.xld + v * 8) * 2, src, inside ? 16 : 0);
  }

  // conv1 -> h. h pixel m is image pixel (y0 - 1 + m / hw, x0 - 1 + m % hw);
  // one outside the image is conv2's zero pad.
  auto h_out = [&](int m, int n, float v0, float v1) {
    const int iy = y0 - 1 + m / p.hw, ix = x0 - 1 + m % p.hw;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    *reinterpret_cast<__nv_bfloat162*>(hs + m * p.hld + n) =
        inside ? __floats2bfloat162_rn(silu_fast(v0 + bs1[n]), silu_fast(v1 + bs1[n + 1]))
               : __floats2bfloat162_rn(0.0f, 0.0f);
  };
  // conv2 -> y. y pixel m is image pixel (y0 + m / TW, x0 + m % TW); its
  // residual is x tile pixel (m / TW + 2, m % TW + 2).
  auto y_out = [&](int m, int n, float v0, float v1) {
    const int oy = m / p.tw, ox = m % p.tw, iy = y0 + oy, ix = x0 + ox;
    if (iy < H && ix < W) {
      const float2 res = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + ((oy + 2) * p.xw + ox + 2) * p.xld + n));
      *reinterpret_cast<__nv_bfloat162*>(y + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + n) =
          __floats2bfloat162_rn(res.x + silu_fast(v0 + bs2[n]), res.y + silu_fast(v1 + bs2[n + 1]));
    }
  };

  conv_wgmma_k<NB>(xs, p.xld, p.xw, p.hw, p.m1, C, Ch, w1, stages, p.stage, tap_off, h_out);
  __syncthreads();  // h complete before conv2 reads it; conv1's stages and table free
  conv_wgmma_k<NB>(hs, p.hld, p.hw, p.tw, p.m2, Ch, C, w2, stages, p.stage, tap_off, y_out);
}

TilePlan make_tile(int th, int tw, int c, int ch, int nb) {
  TilePlan p;
  p.th = th;
  p.tw = tw;
  p.xw = tw + 4;
  p.hw = tw + 2;
  p.m1 = (th + 2) * (tw + 2);
  p.m2 = th * tw;
  p.xld = c + kPixPad;
  p.hld = ch + kPixPad;
  p.stage = kStageK * nb * 2;
  p.h_off = (th + 4) * p.xw * p.xld * 2;
  p.w_off = round_up(p.h_off + p.m1 * p.hld * 2, 128);
  p.t_off = p.w_off + kRing * p.stage;
  p.smem = static_cast<size_t>(p.t_off) + 9 * (c > ch ? c : ch) / 16 * sizeof(int) +
           (c + ch) * sizeof(float);
  return p;
}

// Modelled cycles of one conv of a block on its SM. For each round of up
// to kWarpgroups * mbw 64-row blocks, each stage of each nb-column pass
// costs the larger of the tensor cores' time for the round's blocks (an
// m64nNk16 takes N / 2 cycles at the dense bf16 rate) and a fixed overhead
// (barrier, loads, ldmatrix); the epilogue costs per value it writes.
constexpr double kStageCycles = 700, kEpilogueCycles = 0.05, kLoadBytesPerCycle = 32;

double conv_cycles(int m, int k, int n, int nb, int mbw) {
  const int steps = k % 64 == 0 ? 4 : 3, nstage = 9 * k / (16 * steps);
  const int mblocks = cdiv(m, 64), per_round = kWarpgroups * mbw;
  double cycles = 0;
  for (int mb = 0; mb < mblocks; mb += per_round) {
    const int v = mblocks - mb < per_round ? mblocks - mb : per_round;
    const double mma = v * steps * nb / 2.0;
    cycles += n / nb * nstage * (mma > kStageCycles ? mma : kStageCycles) +
              v * 64.0 * n * kEpilogueCycles;
  }
  return cycles;
}

// The tile with the fewest modelled cycles: waves of blocks over the SMs
// (one block an SM: the block takes most of its registers) times a block's
// cycles, both convs and the x tile's bytes.
bool choose_tile(int batch, int h, int w, int c, int ch, int nb, TilePlan* out) {
  const int mbw = blocks_per_warpgroup(nb);
  const size_t max_smem = static_cast<size_t>(device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  const long sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (max_smem == 0 || sms == 0) return false;
  bool found = false;
  double best = 0;
  for (int th = 1; th <= (h < 64 ? h : 64); ++th) {
    for (int tw = 1; tw <= (w < 64 ? w : 64); ++tw) {
      const TilePlan p = make_tile(th, tw, c, ch, nb);
      if (p.smem > max_smem) continue;
      const long blocks = static_cast<long>(batch) * cdiv(h, th) * cdiv(w, tw);
      const double cost =
          static_cast<double>((blocks + sms - 1) / sms) *
          (conv_cycles(p.m1, c, ch, nb, mbw) + conv_cycles(p.m2, ch, c, nb, mbw) +
           (th + 4) * p.xw * c * 2.0 / kLoadBytesPerCycle);
      if (!found || cost < best) {
        *out = p;
        best = cost;
        found = true;
      }
    }
  }
  return found;
}

template <int NB>
int launch_bf16(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                void* y, int batch, int h, int w, int c, int ch, cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel_bf16<NB>;
  TilePlan p;
  if (!choose_tile(batch, h, w, c, ch, NB, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, cdiv(h, p.th), cdiv(w, p.tw));
  kernel<<<grid, kTcThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2),
      b2, static_cast<bf16*>(y), h, w, c, ch, p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ f32 path (3xTF32)

constexpr int kF32Pad = 4;   // f32 values (16 bytes) after each tile pixel's row
constexpr int kF32Mbw = 2;   // 64-row blocks a warpgroup holds: each takes nb / 2 registers a
                             // thread for its stage sum, nb / 2 for its running sum and 8 a
                             // k8 step for its A fragments (hi and lo)

// the 3xTF32 split of an A value v: hi = tf32(v), lo = tf32(v - hi), each
// rounded to 10 mantissa bits, to nearest with ties away from zero
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(v)));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__uint_as_float(v) - __uint_as_float(hi)));
}

// d = (scale_d ? d : 0) + A (64 x 8, this thread's fragment in a) * B (8 x N,
// descriptor): wgmma.mma_async m64nNk8, tf32 in, f32 sums, A from registers,
// B K-major (tf32 takes no transpose)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The 3xTF32 wgmmas of one weight stage (S k8 steps) for a warpgroup's
// first V 64-row blocks. Each lane's ldmatrix.x4 row is its pixel's
// neighbour for the stage's tap (a_addr holds the tap's offset); its four
// 32-bit values are the m64nNk8 tf32 A fragment, split in registers into hi
// and lo. Every fragment and descriptor is ready before the fence; then per
// k8 step and block a_lo*b_hi (from zero on the stage's first step),
// a_hi*b_lo and a_hi*b_hi, and one commit. B's lo half lies lo_off bytes
// after its hi half.
template <int NB, int V, int S, int MBW>
__device__ __forceinline__ void mma_stage_3xtf32(float (&acc)[MBW][NB / 2],
                                                 const int (&row_off)[MBW], uint32_t a_addr,
                                                 uint32_t b_addr, uint32_t lo_off) {
  uint32_t hi[S][V][4], lo[S][V][4];
  uint64_t desc[2 * S];  // B hi of each step, then B lo
#pragma unroll
  for (int step = 0; step < S; ++step) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + step * 32 + row_off[i]);
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a[r], hi[step][i][r], lo[step][i][r]);
    }
    desc[step] = b_desc(b_addr + step * 256, S * 256);
    desc[S + step] = b_desc(b_addr + lo_off + step * 256, S * 256);
  }
  wgmma_fence(desc);
#pragma unroll
  for (int step = 0; step < S; ++step) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      wgmma_tf32<NB>(acc[i], lo[step][i], desc[step], step > 0);
      wgmma_tf32<NB>(acc[i], hi[step][i], desc[S + step], 1);
      wgmma_tf32<NB>(acc[i], hi[step][i], desc[step], 1);
    }
  }
  wgmma_commit();
}

// mma_stage_3xtf32 for the warpgroup's nvalid (1..V) blocks
template <int NB, int V, int S, int MBW>
__device__ __forceinline__ void mma_stage_3xtf32_n(int nvalid, float (&acc)[MBW][NB / 2],
                                                   const int (&row_off)[MBW], uint32_t a_addr,
                                                   uint32_t b_addr, uint32_t lo_off) {
  if constexpr (V > 1) {
    if (nvalid < V) {
      mma_stage_3xtf32_n<NB, V - 1, S>(nvalid, acc, row_off, a_addr, b_addr, lo_off);
      return;
    }
  }
  mma_stage_3xtf32<NB, V, S>(acc, row_off, a_addr, b_addr, lo_off);
}

// One 3x3 conv of the block's tile in f32 on wgmma, 3xTF32: conv_wgmma's
// implicit GEMM (the same pixel and tap maps; w, (N, 9, K) in core-matrix
// order (N / 8, 9K / 4, 8, 4), split into w_hi and w_lo), with a stage of S k8 steps (S * 8 K', within one tap) for 2 * NB
// columns. Both warpgroups take the same round of up to kF32Mbw 64-row
// blocks, warpgroup wg the stage's columns [wg * NB, +NB). Each stage's
// wgmmas sum from zero into acc; after their wait, acc is added to the
// round's running sums (sum), whose epilogue is epi(m, n, v[n], v[n + 1]).
//
// Loop, as conv_wgmma's: for each stage, wait for it and pass the barrier,
// start loading stage + 1 into the buffer of stage - 2 (cp.async), wait for
// the previous stage's wgmmas and add their sums in, and issue this stage's.
template <int NB, int S, typename Epi>
__device__ __forceinline__ void conv_3xtf32(const float* tile, int ld, int in_w, int out_w, int M,
                                            int K, int N, const float* __restrict__ w_hi,
                                            const float* __restrict__ w_lo, float* stages,
                                            int stage_bytes, Epi epi) {
  static_assert(kRing == 3, "the loop loads one stage ahead into the buffer of stage - 2");
  constexpr int kMbw = kF32Mbw;
  constexpr int kCols = 2 * NB;   // columns of a stage
  constexpr int kGroups = S * 2;  // 16-byte groups of a column in a stage's hi (or lo) half
  constexpr int kStageK = S * 8;  // K' of a stage
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int kk = 9 * K;  // K' of one column
  const int nstage = kk / kStageK;
  const int mblocks = cdiv(M, 64);
  const int nround = cdiv(mblocks, kMbw);
  const int total = N / kCols * nround * nstage;
  const int lo_off = stage_bytes / 2;
  const uint32_t a_addr = smem_addr(tile) + (lane / 16) * 16, stage_addr = smem_addr(stages);
  const uint32_t col_off = wg * (NB / 8) * kGroups * 128;  // this warpgroup's columns in a stage

  // stage `loaded` (K' [ls * kStageK, +kStageK) of columns [lnp * kCols,
  // +kCols)) into buffer loaded % kRing, hi then lo; core matrix (n / 8, g)
  // at byte (n / 8 * kGroups + g) * 128 of its half. w is in core-matrix
  // order, so each 8 columns' kGroups core matrices are one contiguous run,
  // in w as in the buffer. One cp.async group per call; past the last stage
  // an empty one.
  int loaded = 0, ls = 0, lround = 0, lnp = 0;
  auto load_next = [&]() {
    if (loaded < total) {
      const uint32_t dst = stage_addr + (loaded % kRing) * stage_bytes;
      const size_t src = (static_cast<size_t>(lnp) * (kCols / 8) * (kk / 4) + ls * kGroups) * 32;
      for (int i = tid; i < kCols * kGroups; i += kTcThreads) {
        const int j = i / (kGroups * 8), q = i % (kGroups * 8);  // 8 columns j, 16 bytes q
        const size_t o = src + static_cast<size_t>(j) * (kk / 4) * 32 + q * 4;
        cp_async16(dst + i * 16, w_hi + o, 16);
        cp_async16(dst + i * 16 + lo_off, w_lo + o, 16);
      }
      if (++ls == nstage) {
        ls = 0;
        if (++lround == nround) lround = 0, ++lnp;
      }
    }
    cp_async_commit();
    ++loaded;
  };

  float acc[kMbw][NB / 2], sum[kMbw][NB / 2];
  int row_off[kMbw];  // byte offset in the tile of this lane's A row pixel, per block
  int s = 0, round = 0, np = 0;    // the stage about to be issued
  int nvalid = 0, mb0 = 0, n0 = 0;  // the round in the registers: blocks, first block, column

  // the last issued stage's sums, once waited for, into the running sums
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < kMbw; ++i) {
      fence_regs(acc[i]);
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) sum[i][j] += acc[i][j];
    }
  };
  // accumulator layout: d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h,
  // column 8j + 2 * (lane % 4) + e of the 64 x NB block
  auto epilogue = [&]() {
#pragma unroll
    for (int i = 0; i < kMbw; ++i) {
      if (i >= nvalid) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mb0 + i) * 64 + warp * 16 + lane / 4 + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
          epi(m, n0 + 8 * j + 2 * (lane % 4), sum[i][4 * j + 2 * h], sum[i][4 * j + 2 * h + 1]);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kMbw; ++i) {
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) acc[i][j] = 0.0f;
    fence_regs(acc[i]);
  }
  load_next();
  for (int idx = 0; idx < total; ++idx) {
    cp_async_wait<0>();
    __syncthreads();  // stage idx landed for all; all are done with stage idx - 2's buffer
    load_next();      // stage idx + 1
    wgmma_wait<0>();  // stage idx - 1's wgmmas: their registers are free
    if (idx > 0) promote();
    if (s == 0) {
      if (idx > 0) epilogue();  // of the round that stage idx - 1 ended
      mb0 = round * kMbw;
      nvalid = min(kMbw, mblocks - mb0);
      n0 = np * kCols + wg * NB;
#pragma unroll
      for (int i = 0; i < kMbw; ++i) {
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) sum[i][j] = 0.0f;
        const int row = min((mb0 + i) * 64 + warp * 16 + lane % 16, M - 1);
        row_off[i] = ((row / out_w) * in_w + row % out_w) * ld * 4;
      }
    }
    // the stage's tap t and first input channel k
    const int k0 = s * kStageK, t = k0 / K, k = k0 - t * K;
    const uint32_t tap_off = (((t / 3) * in_w + t % 3) * ld + k) * 4;
    mma_stage_3xtf32_n<NB, kMbw, S>(nvalid, acc, row_off, a_addr + tap_off,
                                    stage_addr + (idx % kRing) * stage_bytes + col_off, lo_off);
    if (++s == nstage) {
      s = 0;
      if (++round == nround) round = 0, ++np;
    }
  }
  wgmma_wait<0>();
  promote();
  epilogue();  // of the last round
}

template <int NB, int S>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_bottleneck_kernel_3xtf32(const float* __restrict__ x, const float* __restrict__ w1_hi,
                                   const float* __restrict__ w1_lo, const float* __restrict__ b1,
                                   const float* __restrict__ w2_hi,
                                   const float* __restrict__ w2_lo, const float* __restrict__ b2,
                                   float* __restrict__ y, int H, int W, int C, int Ch,
                                   TilePlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = reinterpret_cast<float*>(smem + p.h_off);
  float* stages = reinterpret_cast<float*>(smem + p.w_off);
  const int b = blockIdx.x, y0 = blockIdx.y * p.th, x0 = blockIdx.z * p.tw;

  // x tile: pixel r is image pixel (y0 - 2 + r / xw, x0 - 2 + r % xw), zero
  // outside the image. cp.async, committed with conv1's first weight stage.
  const int vec = C / 4;
  const uint32_t xs_addr = smem_addr(xs);
  for (int i = threadIdx.x; i < (p.th + 4) * p.xw * vec; i += kTcThreads) {
    const int r = i / vec, v = i % vec;
    const int iy = y0 - 2 + r / p.xw, ix = x0 - 2 + r % p.xw;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const float* src = inside ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + v * 4 : x;
    cp_async16(xs_addr + (r * p.xld + v * 4) * 4, src, inside ? 16 : 0);
  }

  // conv1 -> h in f32. h pixel m is image pixel (y0 - 1 + m / hw, x0 - 1 +
  // m % hw); one outside the image is conv2's zero pad.
  auto h_out = [&](int m, int n, float v0, float v1) {
    const int iy = y0 - 1 + m / p.hw, ix = x0 - 1 + m % p.hw;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    *reinterpret_cast<float2*>(hs + m * p.hld + n) =
        inside ? make_float2(silu(v0 + b1[n]), silu(v1 + b1[n + 1])) : make_float2(0.0f, 0.0f);
  };
  // conv2 -> y. y pixel m is image pixel (y0 + m / TW, x0 + m % TW); its
  // residual is x tile pixel (m / TW + 2, m % TW + 2), added in f32.
  auto y_out = [&](int m, int n, float v0, float v1) {
    const int oy = m / p.tw, ox = m % p.tw, iy = y0 + oy, ix = x0 + ox;
    if (iy < H && ix < W) {
      const float2 res =
          *reinterpret_cast<const float2*>(xs + ((oy + 2) * p.xw + ox + 2) * p.xld + n);
      *reinterpret_cast<float2*>(y + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + n) =
          make_float2(res.x + silu(v0 + b2[n]), res.y + silu(v1 + b2[n + 1]));
    }
  };

  conv_3xtf32<NB, S>(xs, p.xld, p.xw, p.hw, p.m1, C, Ch, w1_hi, w1_lo, stages, p.stage, h_out);
  __syncthreads();  // h complete before conv2 reads it; conv1's stages free
  conv_3xtf32<NB, S>(hs, p.hld, p.hw, p.tw, p.m2, Ch, C, w2_hi, w2_lo, stages, p.stage, y_out);
}

TilePlan make_tile_3xtf32(int th, int tw, int c, int ch, int nb, int s) {
  TilePlan p;
  p.th = th;
  p.tw = tw;
  p.xw = tw + 4;
  p.hw = tw + 2;
  p.m1 = (th + 2) * (tw + 2);
  p.m2 = th * tw;
  p.xld = c + kF32Pad;
  p.hld = ch + kF32Pad;
  p.stage = 2 * (s * 8) * (2 * nb) * 4;  // hi and lo, S * 8 K' x 2 * NB columns of f32
  p.h_off = (th + 4) * p.xw * p.xld * 4;
  p.w_off = round_up(p.h_off + p.m1 * p.hld * 4, 128);
  p.t_off = p.w_off + kRing * p.stage;  // no table: the end of the ring
  p.smem = static_cast<size_t>(p.t_off);
  return p;
}

// Modelled cycles of one 3xTF32 conv of a block on its SM. Each stage of
// each 2 * nb-column pass costs the larger of the tensor cores' time (an
// m64nNk8 tf32 takes N / 2 cycles, three a k8 step, both warpgroups on the
// round's blocks) and its bytes at the rate a block draws them from L2, then
// the ldmatrix and split of its A fragments (they follow the previous
// stage's wait) and a fixed overhead. Fitted to this kernel's times on an
// H100 (the probe's shapes at B=32): ~10 bytes a cycle from L2 a block.
constexpr double kF32StageCycles = 700, kF32SplitCycles = 128, kF32L2BytesPerCycle = 10;

double conv_cycles_3xtf32(int m, int k, int n, int nb, int s) {
  const int nstage = 9 * k / (8 * s), mblocks = cdiv(m, 64), passes = n / (2 * nb);
  const double load = 128.0 * s * nb / kF32L2BytesPerCycle;
  double cycles = 0;
  for (int mb = 0; mb < mblocks; mb += kF32Mbw) {
    const int v = mblocks - mb < kF32Mbw ? mblocks - mb : kF32Mbw;
    const double mma = 3.0 * v * s * nb;
    const double stage = (mma > load ? mma : load) + kF32SplitCycles * s * v + kF32StageCycles;
    cycles += passes * nstage * stage + v * 64.0 * n * kEpilogueCycles;
  }
  return cycles;
}

struct F32Plan {
  TilePlan tile;
  int nb, s;  // columns a warpgroup takes, k8 steps a stage
};

// (nb, s) the f32 kernel is built for: nb columns a warpgroup, s k8 steps a
// stage
constexpr int kF32Configs[][2] = {{64, 2}, {32, 4}, {16, 4}, {8, 2}};

// The plan with the fewest modelled cycles, as choose_tile: over (nb, s)
// and tiles up to 32 x 32
bool choose_plan_3xtf32(int batch, int h, int w, int c, int ch, F32Plan* out) {
  const size_t max_smem = static_cast<size_t>(device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  const long sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (max_smem == 0 || sms == 0) return false;
  bool found = false;
  double best = 0;
  for (const auto& cfg : kF32Configs) {
    const int nb = cfg[0], s = cfg[1];
    // 2 * nb columns a pass, and a stage's 8 * s K' within one tap
    if (c % (2 * nb) || ch % (2 * nb) || c % (8 * s) || ch % (8 * s)) continue;
    for (int th = 1; th <= (h < 32 ? h : 32); ++th) {
      for (int tw = 1; tw <= (w < 32 ? w : 32); ++tw) {
        const TilePlan p = make_tile_3xtf32(th, tw, c, ch, nb, s);
        if (p.smem > max_smem) continue;
        const long blocks = static_cast<long>(batch) * cdiv(h, th) * cdiv(w, tw);
        const double cost =
            static_cast<double>((blocks + sms - 1) / sms) *
            (conv_cycles_3xtf32(p.m1, c, ch, nb, s) + conv_cycles_3xtf32(p.m2, ch, c, nb, s) +
             (th + 4) * p.xw * c * 4.0 / kLoadBytesPerCycle);
        if (!found || cost < best) {
          *out = F32Plan{p, nb, s};
          best = cost;
          found = true;
        }
      }
    }
  }
  return found;
}

template <int NB, int S>
int launch_3xtf32(const F32Plan& p, const float* x, const float* w1_hi, const float* w1_lo,
                  const float* b1, const float* w2_hi, const float* w2_lo, const float* b2,
                  float* y, int batch, int h, int w, int c, int ch, cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel_3xtf32<NB, S>;
  if (p.tile.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.tile.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, cdiv(h, p.tile.th), cdiv(w, p.tile.tw));
  kernel<<<grid, kTcThreads, p.tile.smem, stream>>>(x, w1_hi, w1_lo, b1, w2_hi, w2_lo, b2, y, h,
                                                    w, c, ch, p.tile);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int h, int w, int c, int ch) {
  return batch <= 0 || h <= 0 || w <= 0 || c <= 0 || ch <= 0 || c % 16 || ch % 16;
}

}  // namespace

extern "C" {

// x, y (batch, h, w, c) NHWC bf16, 16-byte aligned; w1 (ch, 3, 3, c) and w2
// (c, 3, 3, ch) bf16 in OHWI order (conv_kernels.weights_ohwi of the HWIO
// weights), 16-byte aligned; b1 (ch,), b2 (c,) f32. c and ch are multiples
// of 16. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue when no tile fits in one block's shared memory).
int yst_fused_bottleneck_bf16(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, void* y, int batch, int h, int w, int c, int ch,
                              void* stream) {
  if (bad_shape(batch, h, w, c, ch)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // columns per pass: the widest of 128/64/32/16 that divides both widths
  const int both = c | ch;
  if (both % 128 == 0) return launch_bf16<128>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, s);
  if (both % 64 == 0) return launch_bf16<64>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, s);
  if (both % 32 == 0) return launch_bf16<32>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, s);
  return launch_bf16<16>(x, w1, b1, w2, b2, y, batch, h, w, c, ch, s);
}

// The same in f32 on wgmma (3xTF32): x, y f32; w1_hi, w1_lo and w2_hi, w2_lo
// f32 holding tf32 values: conv_kernels.tf32_split (hi + lo = the weight
// within 2^-22 of it) of each weight in core-matrix order,
// conv_kernels.weights_core_matrices(weights_ohwi(w)): (ch / 8, 9c / 4, 8, 4)
// and (c / 8, 9ch / 4, 8, 4). All 16-byte aligned.
int yst_fused_bottleneck_f32(const void* x, const void* w1_hi, const void* w1_lo, const float* b1,
                             const void* w2_hi, const void* w2_lo, const float* b2, void* y,
                             int batch, int h, int w, int c, int ch, void* stream) {
  if (bad_shape(batch, h, w, c, ch)) return static_cast<int>(cudaErrorInvalidValue);
  F32Plan p;
  if (!choose_plan_3xtf32(batch, h, w, c, ch, &p)) return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch_3xtf32<8, 2>) launch;
  switch (p.nb * 10 + p.s) {  // the kF32Configs
    case 642: launch = launch_3xtf32<64, 2>; break;
    case 324: launch = launch_3xtf32<32, 4>; break;
    case 164: launch = launch_3xtf32<16, 4>; break;
    case 82: launch = launch_3xtf32<8, 2>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(p, static_cast<const float*>(x), static_cast<const float*>(w1_hi),
                static_cast<const float*>(w1_lo), b1, static_cast<const float*>(w2_hi),
                static_cast<const float*>(w2_lo), b2, static_cast<float*>(y), batch, h, w, c, ch,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
