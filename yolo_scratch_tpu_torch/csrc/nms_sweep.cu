// Greedy-NMS suppression for Hopper (sm_90a), plain C interface: an IoU
// bitmask built on every SM, then a short serial reduce.
//
// Replaces the two Pallas TPU kernels of yolo_scratch_tpu/ops/pallas_nms.py:
//   * yst_nms_sweep_batched  <- _nms_kernel_batched (pallas_call at :160),
//     the Predictor's default NMS at B > 1;
//   * yst_nms_sweep_single   <- _nms_kernel (pallas_call at :89), the B=1
//     path of ops/decode.py::postprocess: the same two kernels at B = 1.
// Bound in Python by yolo_scratch_tpu_torch/ops/nms_kernels.py, which also
// holds the plain PyTorch sweep and each phase in plain PyTorch.
//
// What it computes, for each image (boxes xyxy, score-descending):
//   for i = 0 .. n-1: pivot i is kept iff valid[i] and not suppressed[i];
//   a kept pivot suppresses every j > i with
//     inter / (((area_j + area_i) - inter) + 1e-6) > thr      (f32, strict >)
//   keep[j] = valid[j] && !suppressed[j].
//
// Phase 1, nms_iou_mask_kernel: every pair's suppression bit, computed on
// all SMs, off the serial chain. A block takes one image's tile of 64 rows
// by 64 columns, upper triangle only (column tile >= row tile; past 4096
// boxes the tile index p decodes to its row and column in closed form, and
// runs over grid.y and grid.z, since CUDA caps grid.y at 65,535 tiles);
// each of its 64 threads owns a row i and writes one 64-bit word
// mask[b][i][ct], bit k set iff j = 64 ct + k has i < j < n, boxes i and j
// are valid, and pivot i's IoU with j exceeds thr. An invalid box's bits do
// not matter (it is never kept, and the reduce never ORs in its word), so
// an invalid row's word is 0 and an invalid column's bit is left clear; the
// words left of a row's own tile are never written. What bounds it: the IoU
// tests, n^2/2 per image. A thread first marks the columns that may
// intersect its row (four compares), then divides only for those: with
// inter == 0 the IoU is +-0 or NaN, never > thr when thr >= 0, so the skip
// is exact (a negative thr divides every pair). Most pairs of a detector's
// candidates are disjoint.
//
// Phase 2, nms_reduce_kernel<WPL> (n <= 4096): four warps per image walk
// its ceil(n/64) blocks of 64 pivots in order, with the suppression words
// (remv) in registers, word w in lane w % 32. For block t, every warp
// resolves the 64 pivots against their diagonal words (mask[i][t], loaded
// a block ahead and staged in shared memory): pivot k is kept iff its
// valid bit is set and its remv bit clear, and a kept pivot's word is ORed
// in -- three dependent integer operations a pivot. Warp g then ORs the
// kept rows among the block's rows 16g .. 16g+15 into its share of the later
// remv words (their loads issued before the resolve, so the round trip to
// L2 runs under it), and the four shares of word t+1 meet in shared memory
// once a block. What bounds it: the chain of ceil(n/64) blocks, each a
// resolve of 64 dependent steps and a block-wide barrier. The mask's
// rows are padded to the reduce's 32 or 64 lanes of words
// (yst_nms_mask_stride), so its loads take constant offsets.
//
// Phase 2 past 4096 boxes, nms_reduce_kernel_long: the same walk and the
// same resolve, with remv in shared memory (8 bytes a word: 4.2 KB at
// n = 33,600), so n is bounded by the mask's device memory, not by
// registers. Only word t+1 is on the chain, so the chain and the rest are
// split: warp 0 resolves block t and ORs its kept rows' word t+1 (loaded
// a block ahead) into a carry for block t+1, while the other 31 warps OR
// block t-1's kept rows into words t+1 on: a word to a thread, or to
// several threads that split its kept rows where fewer words than threads
// are left, 8 loads in flight a thread and one shared-memory atomic a
// thread (a 64-bit shared OR is a compare-and-swap loop on sm_90: one a
// load was slower). What bounds it: the chain, a resolve and a barrier a
// block, or the bulk where that is longer: its loads' round trips and, at
// large n, the kept rows' bytes one SM draws (each kept row's words past
// its block, read once). The mask's rows are ceil(n/64) words.
//
// Scratch: the mask takes n * stride * 8 bytes an image (1.1 GB at B=128,
// n=8400). A call sweeps its batch in chunks of images that share one
// scratch buffer, mask then reduce for each chunk on the stream; the
// wrapper sizes the chunk to its cap. Offsets into the mask are 64-bit.
//
// Exactness: the IoU is written with __f*_rn intrinsics in the JAX operation
// order, and the library is built with -fmad=false, so no multiply-add is
// contracted; keep sets equal the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;            // pivots per mask word; threads per mask block
constexpr int kMaxWordsPerLane = 2;  // remv words one reduce lane holds
constexpr int kMaxWords = 32 * kMaxWordsPerLane;  // past this, nms_reduce_kernel_long
constexpr int kReduceWarps = 4;      // a reduce block's warps; each ORs 16 rows of a block
constexpr int kReduceThreads = kReduceWarps * 32;
constexpr int kRowsPerWarp = kTile / kReduceWarps;
constexpr int kLongThreads = 32 * 32;  // the long reduce: one resolving warp, 31 ORing
constexpr int kBulkThreads = kLongThreads - 32;
constexpr int kLoadsInFlight = 8;    // kept rows' words a long-reduce thread loads at once
constexpr int kMaxGridYZ = 65535;    // CUDA's cap on gridDim.y and gridDim.z
constexpr size_t kSharedWithoutOptIn = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr unsigned kFullWarp = 0xffffffffu;

// remv words a reduce lane holds for ceil(n/64) <= 64 words: 1 or 2
__host__ __device__ constexpr int words_per_lane(int words) {
  return words <= 32 ? 1 : kMaxWordsPerLane;
}

// The mask's row stride in words for ceil(n/64) words: the register
// reduce's 32 or 64 lanes of words, else the words themselves.
constexpr int mask_stride(int words) {
  return words <= kMaxWords ? 32 * words_per_lane(words) : words;
}

// Tile p of a words x words upper triangle, numbered row by row (row rt
// holds columns rt .. words-1) -> (rt, ct). Counted from the end, q =
// T-1-p numbers a lower triangle row by row, whose row r starts at
// r(r+1)/2: r from the square root, corrected to the exact integer.
__device__ __forceinline__ void triangle_tile(long long p, int words, int& rt, int& ct) {
  const long long q = static_cast<long long>(words) * (words + 1) / 2 - 1 - p;
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(q) + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > q) --r;
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  rt = words - 1 - static_cast<int>(r);
  ct = words - 1 - static_cast<int>(q - r * (r + 1) / 2);
}

// Candidate a against pivot b, in the sweep's operation order.
__device__ __forceinline__ float intersection(float4 a, float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  return __fmul_rn(w, h);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// A box for the overlap test: NaN becomes the value fminf/fmaxf would pass
// over (x1, y1 feed a max: -inf; x2, y2 a min: +inf), and a box with no
// width or height one that overlaps nothing. Then every pair whose
// intersection is neither 0 nor NaN satisfies overlaps(); so may pairs
// whose w * h underflows to 0 or whose min/max were both NaN, which the
// divide then settles exactly.
__device__ __forceinline__ float4 test_box(float4 b) {
  const float inf = __int_as_float(0x7f800000);
  float4 t = make_float4(isnan(b.x) ? -inf : b.x, isnan(b.y) ? -inf : b.y,
                         isnan(b.z) ? inf : b.z, isnan(b.w) ? inf : b.w);
  if (!(t.z > t.x && t.w > t.y)) t = make_float4(inf, inf, -inf, -inf);
  return t;
}

// min(a.z, b.z) > max(a.x, b.x) and the same in y, on test boxes (whose
// own z > x and w > y): four compares.
__device__ __forceinline__ bool overlaps(float4 a, float4 b) {
  return (a.z > b.x) & (b.z > a.x) & (a.w > b.y) & (b.w > a.y);
}

// Grid (image, tile p mod gridDim.y, p / gridDim.y) over the upper
// triangle's tiles, kTile threads. Row i's words lie at
// mask[(b * n + i) * stride + w], stride = mask_stride(words). valid may
// be null (every box valid).
__global__ void __launch_bounds__(kTile)
    nms_iou_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                        u64* __restrict__ mask, int n, int stride, float thr) {
  __shared__ float4 col[kTile], col_test[kTile];
  __shared__ float col_area[kTile];
  __shared__ unsigned col_valid[kTile / 32];
  const int words = (n + kTile - 1) / kTile;
  int rt = 0, ct;
  if (words <= kMaxWords) {  // n <= 4096: a short walk down the rows
    int p = blockIdx.y;
    while (p >= words - rt) {
      p -= words - rt;
      ++rt;
    }
    ct = rt + p;
  } else {
    const long long p = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
    if (p >= static_cast<long long>(words) * (words + 1) / 2) return;  // the last z's spare tiles
    triangle_tile(p, words, rt, ct);
  }
  const size_t img = blockIdx.x;
  boxes += img * n;
  if (valid) valid += img * n;

  const int tid = threadIdx.x, j = ct * kTile + tid;
  const float4 c = j < n ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  col[tid] = c;
  col_test[tid] = test_box(c);
  col_area[tid] = box_area(c);
  const unsigned vj = __ballot_sync(kFullWarp, j < n && (!valid || valid[j]));
  if (tid % 32 == 0) col_valid[tid / 32] = vj;
  __syncthreads();
  const int i = rt * kTile + tid;
  if (i >= n) return;
  u64* out = mask + (img * n + i) * stride + ct;
  if (valid && !valid[i]) {  // an invalid pivot is never kept: its words stay 0
    *out = 0;
    return;
  }
  const float4 piv = boxes[i];
  const float parea = box_area(piv);

  // The valid columns j > i. An invalid j is never kept whatever its bit,
  // and never suppresses, so its bit is left 0.
  u64 cand = static_cast<u64>(col_valid[1]) << 32 | col_valid[0];
  if (ct == rt) cand &= tid == kTile - 1 ? 0ull : ~0ull << (tid + 1);
  if (thr >= 0.0f) {  // uniform: keep only the columns that may intersect row i
    const float4 piv_test = test_box(piv);
    u64 hit = 0;
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      hit |= static_cast<u64>(overlaps(col_test[k], piv_test)) << k;
    cand &= hit;
  }
  u64 bits = 0;
  while (cand) {
    const int k = __ffsll(static_cast<long long>(cand)) - 1;
    cand &= cand - 1;
    const float inter = intersection(col[k], piv);
    const float denom = __fadd_rn(__fsub_rn(__fadd_rn(col_area[k], parea), inter), 1e-6f);
    if (__fdiv_rn(inter, denom) > thr) bits |= 1ull << k;
  }
  *out = bits;
}

// One resolve step on the low half of remv word t: if bit `bit` of lo is
// clear (pivot kept), OR the pivot's diagonal word into lo:hi. The bit is
// multiplied up to the sign and spread into a mask: three dependent
// operations a pivot (a predicated OR waits longer on its predicate).
__device__ __forceinline__ void resolve_lo(unsigned& lo, unsigned& hi, unsigned bit,
                                           unsigned dlo, unsigned dhi) {
  const unsigned m = static_cast<unsigned>(static_cast<int>(lo * (0x80000000u / bit)) >> 31);
  lo |= ~m & dlo;
  hi |= ~m & dhi;
}

// The same on the high half: pivots 32..63 suppress only bits above 32.
__device__ __forceinline__ void resolve_hi(unsigned& hi, unsigned bit, unsigned dhi) {
  const unsigned m = static_cast<unsigned>(static_cast<int>(hi * (0x80000000u / bit)) >> 31);
  hi |= ~m & dhi;
}

// Grid (image), kReduceWarps warps; WPL remv words a lane, so
// n <= 64 * 32 * WPL. Every warp resolves each block itself (the chain is
// short and the warps run on their own schedulers); warp g ORs rows
// 16g .. 16g+15 of each block into its share of the remv words, and the
// shares of word t+1 meet in shared memory once a block.
template <int WPL>
__global__ void __launch_bounds__(kReduceWarps * 32)
    nms_reduce_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int n) {
  constexpr int kStride = 32 * WPL;  // the mask's row stride, in words
  __shared__ u64 diag[kReduceWarps][kTile];
  __shared__ u64 share[2][kReduceWarps];  // each warp's share of remv word t, by t's parity
  const int words = (n + kTile - 1) / kTile;
  const size_t img = blockIdx.x;
  mask += img * n * kStride;
  valid += img * n;
  keep += img * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 remv[WPL];  // this warp's share: its rows' words, ORed over the kept rows
#pragma unroll
  for (int q = 0; q < WPL; ++q) remv[q] = 0;
  if (lane == 0) share[0][warp] = 0;
  __syncthreads();

  // block t's diagonal words and valid flags, rows 64t + lane and 64t + 32 + lane,
  // loaded one block ahead
  struct Block {
    u64 d0, d1;
    bool v0, v1;
  };
  auto load_block = [&](int t) {
    const int i0 = t * kTile + lane, i1 = i0 + 32;
    Block b;
    b.v0 = i0 < n && valid[i0];
    b.v1 = i1 < n && valid[i1];
    b.d0 = i0 < n ? mask[static_cast<size_t>(i0) * kStride + t] : 0;
    b.d1 = i1 < n ? mask[static_cast<size_t>(i1) * kStride + t] : 0;
    return b;
  };
  Block cur = load_block(0);
  for (int t = 0; t < words; ++t) {
    u64* dg = diag[warp];
    dg[lane] = cur.d0;
    dg[lane + 32] = cur.d1;
    const u64 vbits = __ballot_sync(kFullWarp, cur.v0) |
                      static_cast<u64>(__ballot_sync(kFullWarp, cur.v1)) << 32;
    cur = load_block(t + 1);  // in flight during this block

    // This warp's 16 rows of the block, their later words (which rows are
    // kept is not known yet). With one word a lane they are loaded here, so
    // that the round trip to L2 runs under the resolve.
    const u64* rows = mask + static_cast<size_t>(t * kTile + warp * kRowsPerWarp) * kStride;
    u64 pre[kRowsPerWarp];
    if constexpr (WPL == 1) {
      if (lane > t && lane < words) {
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) pre[k] = rows[k * kStride + lane];
      }
    }

    // remv word t, from the warps' shares; an invalid pivot counts as
    // suppressed, so it is never kept and its word never ORed in
    u64 r = ~vbits;
#pragma unroll
    for (int g = 0; g < kReduceWarps; ++g) r |= share[t & 1][g];
    __syncwarp();  // dg is visible to every lane
    unsigned lo = static_cast<unsigned>(r), hi = static_cast<unsigned>(r >> 32);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const u64 d = dg[k];
      resolve_lo(lo, hi, 1u << k, static_cast<unsigned>(d), static_cast<unsigned>(d >> 32));
    }
#pragma unroll
    for (int k = 0; k < 32; ++k)
      resolve_hi(hi, 1u << k, static_cast<unsigned>(dg[32 + k] >> 32));
    const u64 kept = ~(static_cast<u64>(hi) << 32 | lo);
    if (kept) {
      // this warp's kept rows' words w > t, into the lanes that hold them
      const unsigned mine = static_cast<unsigned>(kept >> (warp * kRowsPerWarp)) & 0xffffu;
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        const int w = lane + 32 * q;
        if (w > t && w < words) {
          if constexpr (WPL > 1) {
#pragma unroll
            for (int k = 0; k < kRowsPerWarp; ++k) pre[k] = rows[k * kStride + w];
          }
          u64 acc[2] = {0, 0};  // two short OR chains
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k) acc[k & 1] |= mine >> k & 1 ? pre[k] : 0;
          remv[q] |= acc[0] | acc[1];
        }
      }
    }
    if (warp == 0) {
      const int i0 = t * kTile + lane;
      if (i0 < n) keep[i0] = kept >> lane & 1;
      if (i0 + 32 < n) keep[i0 + 32] = kept >> (lane + 32) & 1;
    }

    // this warp's share of word t+1; the barrier also ends every read of
    // dg and of share[t & 1] before they are written again
    const int t1 = t + 1;
    if (t1 < words && lane == (t1 & 31)) {
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        if (t1 >> 5 == q) share[t1 & 1][warp] = remv[q];
    }
    __syncthreads();
  }
}

// Grid (image), kLongThreads threads, dynamic shared memory of
// ceil(n/64) words (remv). Any n; the register kernel runs up to 4096.
// Iteration t: warp 0 resolves block t, then ORs the kept rows' word t+1
// (loaded a block ahead) into its carry for block t+1; meanwhile the other
// warps OR block t-1's kept rows into words t+1 on (the bulk, off the
// chain). One barrier an iteration.
__global__ void __launch_bounds__(kLongThreads)
    nms_reduce_kernel_long(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ keep, int n, int stride) {
  extern __shared__ u64 remv[];    // word w: ORed over the kept rows of blocks < w - 1
  __shared__ u64 diag[kTile];      // warp 0's: block t's diagonal words
  __shared__ uint8_t kept_row[2][kTile];  // block t's kept rows in order, by t's parity
  __shared__ int kept_count[2];
  const int words = (n + kTile - 1) / kTile;
  const size_t img = blockIdx.x;
  mask += img * n * stride;
  valid += img * n;
  keep += img * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int w = tid; w < words; w += kLongThreads) remv[w] = 0;
  if (tid < 2) kept_count[tid] = 0;  // "block -1" kept nothing
  __syncthreads();

  // warp 0: block t's rows 64t + lane and 64t + 32 + lane, their valid
  // flags, diagonal words and words t+1, loaded one block ahead
  struct Block {
    u64 d0, d1, c0, c1;
    bool v0, v1;
  };
  auto load_block = [&](int t) {
    const int i0 = t * kTile + lane, i1 = i0 + 32;
    const bool next = t + 1 < words;
    Block b;
    b.v0 = i0 < n && valid[i0];
    b.v1 = i1 < n && valid[i1];
    b.d0 = i0 < n ? mask[static_cast<size_t>(i0) * stride + t] : 0;
    b.d1 = i1 < n ? mask[static_cast<size_t>(i1) * stride + t] : 0;
    b.c0 = i0 < n && next ? mask[static_cast<size_t>(i0) * stride + t + 1] : 0;
    b.c1 = i1 < n && next ? mask[static_cast<size_t>(i1) * stride + t + 1] : 0;
    return b;
  };
  Block cur;
  u64 carry = 0;  // warp 0: block t-1's kept rows' word t
  if (warp == 0) cur = load_block(0);
  for (int t = 0; t < words; ++t) {
    if (warp == 0) {
      diag[lane] = cur.d0;
      diag[lane + 32] = cur.d1;
      const u64 vbits = __ballot_sync(kFullWarp, cur.v0) |
                        static_cast<u64>(__ballot_sync(kFullWarp, cur.v1)) << 32;
      const u64 c0 = cur.c0, c1 = cur.c1;
      cur = load_block(t + 1);  // in flight during this block
      // remv word t: blocks < t-1 (the bulk) and block t-1 (the carry); an
      // invalid pivot counts as suppressed
      const u64 r = ~vbits | remv[t] | carry;
      __syncwarp();  // diag is visible to every lane
      unsigned lo = static_cast<unsigned>(r), hi = static_cast<unsigned>(r >> 32);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const u64 d = diag[k];
        resolve_lo(lo, hi, 1u << k, static_cast<unsigned>(d), static_cast<unsigned>(d >> 32));
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        resolve_hi(hi, 1u << k, static_cast<unsigned>(diag[32 + k] >> 32));
      const u64 kept = ~(static_cast<u64>(hi) << 32 | lo);
      const bool k0 = kept >> lane & 1, k1 = kept >> (lane + 32) & 1;
      const int i0 = t * kTile + lane;
      if (i0 < n) keep[i0] = k0;
      if (i0 + 32 < n) keep[i0 + 32] = k1;
      // the bulk's list of block t's kept rows, in order
      const u64 below = (1ull << lane) - 1;
      if (k0) kept_row[t & 1][__popcll(kept & below)] = static_cast<uint8_t>(lane);
      if (k1) kept_row[t & 1][__popcll(kept & (below << 32 | 0xffffffffull))] =
          static_cast<uint8_t>(lane + 32);
      if (lane == 0) kept_count[t & 1] = __popcll(kept);
      const u64 c = (k0 ? c0 : 0) | (k1 ? c1 : 0);
      const unsigned c_hi = __reduce_or_sync(kFullWarp, static_cast<unsigned>(c >> 32));
      carry = static_cast<u64>(c_hi) << 32 | __reduce_or_sync(kFullWarp, static_cast<unsigned>(c));
    } else if (const int count = t + 1 < words ? kept_count[(t + 1) & 1] : 0) {
      // the bulk: block t-1's kept rows' words t+1+w, w < span (word t came
      // through the carry). Thread m takes word m mod span and, when span
      // < 992, the kept rows g, g + groups, ... of g = m / span (several
      // threads a word), else every kept row of words m, m + 992, ...; it
      // ORs them kLoadsInFlight loads at a time and its word into remv
      // once: one atomic a thread, not one a load
      const uint8_t* rows_kept = kept_row[(t + 1) & 1];
      const u64* rows = mask + static_cast<size_t>(t - 1) * kTile * stride + t + 1;
      const int span = words - t - 1, m = tid - 32;
      const int groups = span >= kBulkThreads ? 1 : kBulkThreads / span;
      const int g = m / span;
      for (int w = m % span; g < groups && w < span; w += kBulkThreads) {
        u64 acc = 0;
        for (int j0 = g; j0 < count; j0 += groups * kLoadsInFlight) {
          u64 v[kLoadsInFlight];
#pragma unroll
          for (int q = 0; q < kLoadsInFlight; ++q) {
            const int j = j0 + q * groups;
            v[q] = j < count ? rows[static_cast<size_t>(rows_kept[j < count ? j : 0]) * stride + w]
                             : 0;
          }
#pragma unroll
          for (int q = 0; q < kLoadsInFlight; ++q) acc |= v[q];
        }
        if (acc) atomicOr(&remv[t + 1 + w], acc);
      }
    }
    // block t's kept rows are published, block t-1's bulk is done, and
    // every read of the lists of block t-1 has ended
    __syncthreads();
  }
}

int launch_mask(const float* boxes, const uint8_t* valid, u64* mask, int batch, int n,
                float thr, cudaStream_t stream) {
  const int words = (n + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(words) * (words + 1) / 2;
  const long long y = tiles < kMaxGridYZ ? tiles : kMaxGridYZ, z = (tiles + y - 1) / y;
  if (z > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch, static_cast<unsigned>(y), static_cast<unsigned>(z));
  nms_iou_mask_kernel<<<grid, kTile, 0, stream>>>(reinterpret_cast<const float4*>(boxes),
                                                  valid, mask, n, mask_stride(words), thr);
  return static_cast<int>(cudaGetLastError());
}

int launch_reduce(const u64* mask, const uint8_t* valid, uint8_t* keep, int batch, int n,
                  cudaStream_t stream) {
  const int words = (n + kTile - 1) / kTile;
  if (words <= 32) {
    nms_reduce_kernel<1><<<batch, kReduceThreads, 0, stream>>>(mask, valid, keep, n);
  } else if (words <= kMaxWords) {
    nms_reduce_kernel<kMaxWordsPerLane><<<batch, kReduceThreads, 0, stream>>>(mask, valid,
                                                                              keep, n);
  } else {
    const size_t shared = static_cast<size_t>(words) * sizeof(u64);
    constexpr size_t static_bytes = sizeof(u64) * kTile + 2 * kTile + 2 * sizeof(int);
    if (shared + static_bytes > kSharedWithoutOptIn) {  // past 388,032 boxes
      const cudaError_t err = cudaFuncSetAttribute(
          nms_reduce_kernel_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    nms_reduce_kernel_long<<<batch, kLongThreads, shared, stream>>>(mask, valid, keep, n,
                                                                    words);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batch in chunks of `chunk` images, which share the mask scratch
// (chunk images' worth); the stream orders each chunk's kernels after the
// last chunk's.
int launch_sweep(const float* boxes, const uint8_t* valid, uint8_t* keep, u64* mask,
                 int batch, int n, int chunk, float thr, void* stream_ptr) {
  if (batch <= 0 || n <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int b0 = 0; b0 < batch; b0 += chunk) {
    const int imgs = batch - b0 < chunk ? batch - b0 : chunk;
    const size_t off = static_cast<size_t>(b0) * n;
    if (const int err = launch_mask(boxes + 4 * off, valid + off, mask, imgs, n, thr, stream))
      return err;
    if (const int err = launch_reduce(mask, valid + off, keep + off, imgs, n, stream))
      return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) f32 contiguous, 16-byte aligned; valid, keep (batch, n)
// bytes (0/1); mask (chunk, n, yst_nms_mask_stride(n)) 64-bit words of
// scratch, which need no initialisation, for chunk images at a time.
// Returns the cudaError_t of the launches (0 on success).
int yst_nms_sweep_batched(const float* boxes, const uint8_t* valid, uint8_t* keep, u64* mask,
                          int batch, int n, int chunk, float thr, void* stream) {
  return launch_sweep(boxes, valid, keep, mask, batch, n, chunk, thr, stream);
}

// boxes (n, 4), valid, keep (n,), mask (n, yst_nms_mask_stride(n)): one image.
int yst_nms_sweep_single(const float* boxes, const uint8_t* valid, uint8_t* keep, u64* mask,
                         int n, float thr, void* stream) {
  return launch_sweep(boxes, valid, keep, mask, 1, n, 1, thr, stream);
}

// Phase 1 alone (for tests): writes the upper triangle of mask (batch, n,
// stride); valid may be null.
int yst_nms_iou_mask(const float* boxes, const uint8_t* valid, u64* mask, int batch, int n,
                     float thr, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mask(boxes, valid, mask, batch, n, thr, static_cast<cudaStream_t>(stream));
}

// The mask's row stride in 64-bit words: ceil(n/64), rounded up to whole
// lanes of the register reduce (32 or 64) up to n = 4096, so that its
// loads take constant offsets.
int yst_nms_mask_stride(int n) { return mask_stride((n + kTile - 1) / kTile); }

}  // extern "C"
