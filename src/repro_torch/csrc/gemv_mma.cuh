// The decode-tier GEMV block for Hopper (sm_90a): Y = quantize(X) @ W for
// M <= 32 token rows on the tensor cores, K split across the eight blocks
// of a thread-block cluster.  w1a8_gemv.cu builds both decode kernels
// (w1a8_gemv, decoupled_gemv) from these pieces.
//
// The product is transposed, Y^T = W^T X^T, so that the token rows are the
// narrow side of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: A (16 x
// 32) is 16 weight columns by one k32 step, B (32 x 8) the step's int8
// codes of 8 token rows, and M <= 32 rows take NT = ceil(M / 8) MMAs per
// 16 columns per step, all from one read of the weight.
//
// Work split.  A cluster owns 256 output columns and all of K; its block
// of rank q owns the q-th eighth of the k32 steps (the last steps may hold
// none).  A block has 8 warps, warp w owning columns 32 w .. 32 w + 31 of
// the cluster's 256 over the block's whole K slice, so a warp's sums need
// no reduction inside the block.  w1a8_gemv at N 2048 runs 8 clusters (64
// blocks); decoupled_gemv at N 5024 + r 384 runs 20 packed and 2 int8.
//
// Per block, in order:
//   1. the first 16-byte loads of the block's x slice (f32 or bf16 as
//      given) go out, then cp.async (16 bytes a thread, all at once) stages
//      the weight slice into shared memory;
//   2. act-quant, once per cluster, while the weight arrives: each block
//      takes each row's abs-max over its own K slice and sends it to every
//      block of the cluster (st.async into distributed shared memory,
//      DSMEM, completing on the receiver's mbarrier); each computes gamma =
//      127 / (amax + 1e-5) with IEEE division (max is exact in any order,
//      so every block gets the plain version's gamma) and quantizes only
//      its own slice into shared memory, with round-half-even and a clip
//      to +-127; pad rows and the K tail past K get zero codes;
//   3. the MMAs over the slice, A built in registers from the staged
//      weight: a packed sign nibble is one word of A (sign_word), an int8
//      column's four K values one word after a 4 x 4 byte transpose;
//   4. each warp sends its sums of row r to the block of rank r % 8
//      (st.async again; int16 where a sum must fit, see narrow_sums),
//      which waits on its mbarrier for the 8 blocks' sums of its rows,
//      adds them in int32 (exact in any order) and applies the epilogue.
// The only cluster barrier is split: every block arrives as it starts and
// waits just before its first DSMEM store, so that no block writes into
// one that has not started.
//
// The K order inside a k32 step.  Lane l = 4 g + t of a warp holds A rows
// g and g + 8 at MMA K quads t and t + 4, and B column g at the same
// quads.  Here quad t is K 8t .. 8t+3 of the step and quad t + 4 is K
// 8t+4 .. 8t+7: one packed byte (its low and high nibble) feeds both of a
// lane's quads for one weight column, and its B fragment is the 8
// consecutive codes 8t .. 8t+7 of one token row (one 8-byte load).  A row
// g of MMA tile tau (tau = 0, 1) is the warp's column 4 g + 2 tau, A row g
// + 8 column 4 g + 2 tau + 1, so a lane's A words of a step come from one
// 4-byte word of packed row 4 s + t (columns 4 g .. 4 g + 3), and its
// accumulators of one token row are four adjacent columns.
//
// Shared-memory strides are chosen so that every fragment read hits 32
// distinct banks (see Plan).
#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"   // mma_s8, transpose4x4, cp_async16, store_out
#include "wgmma_pipe.cuh"  // sign_word, mbarriers

namespace repro_gemv {

namespace cg = cooperative_groups;
namespace rt = repro_tile;
namespace sm90 = repro_sm90;

constexpr int kCluster = 8;            // blocks of a cluster, one K slice each
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32 * kWarps;     // output columns of a cluster (32 a warp)
constexpr int kMaxRows = 32;           // token rows a launch takes
constexpr int kPackedLd = kCols + 32;  // packed stage row stride: rows 4 s + t on 8-bank offsets
constexpr int kSumsLd = kCols + 8;     // a sums slot's row stride, in sums (int32 or int16)
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block may use on sm_90

// Each kernel's blocks an SM must hold (so registers are capped at 65536 /
// (256 x that)) and the x loads a thread keeps in registers.  Eight blocks
// of a cluster must find room in one GPC at once: an H100 holds 15
// clusters of 8 blocks that fill an SM each.  w1a8_gemv at N 2048 runs 8
// clusters, one block an SM, with room to keep a K 5024 slice of 32 rows
// in registers; decoupled_gemv at pquant-1.3b's widths (N 5024 + r 384)
// runs 22 clusters, two blocks an SM.
template <bool kDecoupled>
struct Config {
  static constexpr int kMinBlocks = 1, kBatch = 24;
};
template <>
struct Config<true> {
  static constexpr int kMinBlocks = 2, kBatch = 8;
};

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// The shared memory of one block, the same for every block of a launch:
//   w     the weight slice: packed, per k32 step 4 rows of kCols bytes at
//         kPackedLd; or (decoupled_gemv's int8 clusters) int8, per step 32
//         rows of kCols bytes, 16-byte chunks swizzled.  Where the whole
//         slice would not fit beside the rest (a long K: granite-20b's
//         w1_down at K 24576 and 32 rows, deepseek-coder-33b's int8 branch
//         at K 7168), it is staged and multiplied in passes of w_steps
//         steps, in step order (the same int32 sums);
//   sums  the int32 (or int16) sums that the 8 blocks send this block:
//         of rows rank + 8 i, one slot (NT rows at kSumsLd) per sender;
//   xq    the int8 codes (mpad rows at xq_ld = 32 mod 128 bytes);
//   amax_all  the row maxima the 8 blocks send (8 x 32 floats);
//   amax, gamma: one float per row; two mbarriers (maxima, sums).
// x itself is never staged: each thread keeps its loads in registers.
struct Plan {
  int steps;    // k32 steps of a block (the last blocks may have fewer)
  int w_steps;  // k32 steps of one staging pass (steps where one pass fits)
  int mpad;     // M rounded up to 8 (NT = mpad / 8)
  int xq_ld;
  size_t sums_off, xq_off, amax_all_off, amax_off, gamma_off, bar_off, total;
};

template <bool kDecoupled>
__host__ __device__ inline Plan make_plan(int m, int k) {
  Plan p;
  const int total_steps = (k + 31) / 32;
  p.steps = (total_steps + kCluster - 1) / kCluster;
  p.mpad = (int)round_up((size_t)m, 8);
  p.xq_ld = (int)round_up((size_t)p.steps * 32 - 32, 128) + 32;
  // the fewest passes whose weight stage fits (one, where the slice does)
  for (int passes = 1;; ++passes) {
    p.w_steps = (p.steps + passes - 1) / passes;
    const size_t w_bytes = (size_t)p.w_steps * (kDecoupled ? 32 * kCols : 4 * kPackedLd);
    p.sums_off = round_up(w_bytes, 128);
    // NT rows of int32 from each of the 8 blocks
    p.xq_off = p.sums_off + round_up((size_t)(p.mpad / 8) * kCluster * kSumsLd * 4, 128);
    p.amax_all_off = p.xq_off + round_up((size_t)p.mpad * p.xq_ld, 128);
    p.amax_off = p.amax_all_off + kCluster * kMaxRows * sizeof(float);
    p.gamma_off = p.amax_off + kMaxRows * sizeof(float);
    p.bar_off = p.gamma_off + kMaxRows * sizeof(float);
    p.total = p.bar_off + 2 * sizeof(uint64_t);
    if (p.total <= kMaxSmem || p.w_steps <= 1) return p;
  }
}

// The k32 steps [lo, hi) of K that cluster rank `rank` owns.
__device__ __forceinline__ void step_slice(int k, int steps, int rank, int& lo, int& hi) {
  const int total = (k + 31) / 32;
  lo = min(total, rank * steps);
  hi = min(total, lo + steps);
}

// ---- the cluster: its split barrier, DSMEM addresses, st.async ----

// Arrive (release: the mbarriers' initialisation is published) as the
// block starts; wait (acquire) before the first DSMEM store.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared::cluster address of this block's shared `p` in block `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(sm90::smem_addr(p)),
               "r"(rank));
  return r;
}

// Stores into another block's shared memory that complete their bytes on
// that block's mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// The blocks' int32 sums travel as int16 where they must fit: a packed
// (+-1) weight over a K slice of at most 256 values gives |sum| <= 256 x
// 127 < 2^15 (K <= 2048, the attention projections and the FFN gate/up).
__host__ __device__ inline bool narrow_sums(const Plan& p, bool int8_branch) {
  return !int8_branch && p.steps * 32 * 127 <= 32767;
}

// Thread 0 at the start: the two mbarriers, each expecting its bytes (the
// 8 blocks' maxima of m rows; the 8 blocks' sums of this block's rows
// rank + 8 i < m, kCols of `sum_bytes` each), and amax zeroed; then every
// thread arrives on the cluster barrier.
__device__ __forceinline__ void exchange_init(const Plan& p, uint8_t* smem, int m, int rank,
                                              int sum_bytes) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  if (threadIdx.x < kMaxRows) reinterpret_cast<float*>(smem + p.amax_off)[threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars[0], 1);
    sm90::mbar_init(&bars[1], 1);
    const int rows = rank < m ? (m - rank + kCluster - 1) / kCluster : 0;
    sm90::mbar_expect_tx(&bars[0], kCluster * m * (int)sizeof(float));
    sm90::mbar_expect_tx(&bars[1], rows * kCluster * kCols * sum_bytes);
    sm90::mbar_fence_init();
  }
  cluster_arrive();
}

// Stage `rows` rows of `row_bytes` bytes (valid: the first `valid_rows`
// rows and, of each, the bytes before `valid_bytes`; zeros elsewhere) from
// global `src` (row stride `src_ld` bytes) into shared `dst` (row stride
// `dst_ld`), 16-byte chunk c of row i stored at chunk c ^ swz(i).  By
// cp.async where `aligned` (src, src_ld and valid_bytes multiples of 16),
// else byte by byte.
template <class Swz>
__device__ __forceinline__ void stage(uint8_t* dst, int dst_ld, const uint8_t* __restrict__ src,
                                      size_t src_ld, int rows, int row_bytes, int valid_rows,
                                      int valid_bytes, bool aligned, Swz swz) {
  if (aligned) {
    const int chunks = row_bytes / 16;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
      const int i = idx / chunks, c = idx % chunks;
      const bool ok = i < valid_rows && 16 * c < valid_bytes;
      // a zero-byte copy still needs a valid address: point it at src itself
      rt::cp_async16(dst + (size_t)i * dst_ld + 16 * (c ^ swz(i)),
                     ok ? src + i * src_ld + 16 * c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * row_bytes; idx += kThreads) {
      const int i = idx / row_bytes, b = idx % row_bytes;
      const bool ok = i < valid_rows && b < valid_bytes;
      dst[(size_t)i * dst_ld + 16 * ((b >> 4) ^ swz(i)) + (b & 15)] = ok ? src[i * src_ld + b] : 0;
    }
  }
  rt::cp_async_commit();
}

struct NoSwizzle {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};
// int8 stage: row i = 32 s + 8 t + j is read by the lanes of quad t, so
// its chunks are XORed with 2 t and the four quads' reads of a column
// word fall in distinct banks.
struct Int8Swizzle {
  __device__ __forceinline__ int operator()(int i) const { return ((i >> 3) & 3) << 1; }
};

// A no-op hook at the act-quant's inner step boundaries (points 0-3: x
// loaded and its maxima taken, the cluster's blocks all started, the
// maxima exchanged, the codes written); a measurement passes its own.
struct NoMark {
  __device__ __forceinline__ void operator()(int) const {}
};

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// clip(rint(v * g), -127, 127) of four values as four int8 lanes of a word
// (rintf rounds half to even, as torch.round).
__device__ __forceinline__ uint32_t quantize4(float4 v, float g) {
  const auto q = [g](float f) {
    return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(f * g), -127.0f), 127.0f);
  };
  return q(v.x) | (q(v.y) << 8) | (q(v.z) << 16) | (q(v.w) << 24);
}

// A 16-byte load of x as float4 groups: four f32 values, or eight bf16
// values widened to f32 (exact).
__device__ __forceinline__ float4 f32x4(uint4 u) {
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                     __uint_as_float(u.w));
}
__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u));
}
__device__ __forceinline__ float item_abs_max(uint4 u, const float*) { return abs_max4(f32x4(u)); }
__device__ __forceinline__ float item_abs_max(uint4 u, const __nv_bfloat16*) {
  return fmaxf(abs_max4(bf16x4(u.x, u.y)), abs_max4(bf16x4(u.z, u.w)));
}
// The item's codes at q (one word for f32, two for bf16).
__device__ __forceinline__ void item_quantize(uint4 u, float g, uint32_t* q, const float*) {
  *q = quantize4(f32x4(u), g);
}
__device__ __forceinline__ void item_quantize(uint4 u, float g, uint32_t* q,
                                              const __nv_bfloat16*) {
  *reinterpret_cast<uint2*>(q) =
      make_uint2(quantize4(bf16x4(u.x, u.y), g), quantize4(bf16x4(u.z, u.w), g));
}

// A thread's share of the block's x slice (m x k, row-major; K values [k0,
// k0 + len)): the rows go to groups of tpr = kThreads / next_pow2(m)
// threads, each taking every tpr-th 16-byte item of its row; v holds its
// first kBatch items (the loads it keeps in flight at once).
template <class In, int kBatch>
struct XSlice {
  const In* x;
  const uint4* xr;  // the thread's row at k0
  int row, j, tpr, items;
  uint4 v[kBatch];
};

// Step 1's loads: the thread's first kBatch items.
template <class In, int kBatch>
__device__ __forceinline__ void load_x(XSlice<In, kBatch>& s, const In* __restrict__ x, int m,
                                       int k, int k0, int len) {
  int rows = 1;
  while (rows < m) rows <<= 1;
  s.x = x;
  s.tpr = kThreads / rows;
  s.row = threadIdx.x / s.tpr;
  s.j = threadIdx.x % s.tpr;
  s.items = len * (int)sizeof(In) / 16;
  s.xr = reinterpret_cast<const uint4*>(x + (size_t)s.row * k + k0);
  if (s.row < m)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {  // a break, not a guard: no predicated dead loads
      if (s.j + b * s.tpr >= s.items) break;
      s.v[b] = __ldg(s.xr + s.j + b * s.tpr);
    }
}

// x loads a thread keeps in flight past its first kBatch
constexpr int kMore = 8;

// Step 2: the act-quant of the slice into xq, `words` code words a row.
// Items past the first kBatch are read, kMore at a time, once for the max
// and again (from L1 or L2) for the codes.  The block's row maxima
// (atomicMax on the float's bits, which orders non-negative floats, into
// amax, zeroed by exchange_init) go to every block of the cluster.
template <class In, int kBatch, class Mark = NoMark>
__device__ __forceinline__ void quantize_slice(XSlice<In, kBatch>& s, const Plan& p,
                                               uint8_t* smem, int m, int rank, int words,
                                               Mark mark = {}) {
  constexpr int kWords = 16 / (int)sizeof(In) / 4;  // code words per 16-byte item
  uint32_t* xq = reinterpret_cast<uint32_t*>(smem + p.xq_off);
  float* amax_all = reinterpret_cast<float*>(smem + p.amax_all_off);
  float* amax_s = reinterpret_cast<float*>(smem + p.amax_off);
  float* gamma_s = reinterpret_cast<float*>(smem + p.gamma_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const int tpr = s.tpr, row = s.row, j = s.j, items = s.items, stride = tpr * kMore;
  float amax = 0.0f;
  if (row < m) {
    for (int i0 = j + tpr * kBatch; i0 < items; i0 += stride) {
      uint4 u[kMore];
#pragma unroll
      for (int b = 0; b < kMore; ++b)
        u[b] = i0 + b * tpr < items ? __ldg(s.xr + i0 + b * tpr) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int b = 0; b < kMore; ++b) amax = fmaxf(amax, item_abs_max(u[b], s.x));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j + b * tpr >= items) break;
      amax = fmaxf(amax, item_abs_max(s.v[b], s.x));
    }
  }
  const int width = tpr < 32 ? tpr : 32;  // a row's threads inside one warp
  for (int o = 1; o < width; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  mark(0);
  __syncthreads();  // amax zeroed
  if (row < m && (threadIdx.x & (width - 1)) == 0)
    atomicMax(reinterpret_cast<int*>(amax_s) + row, __float_as_int(amax));
  cluster_wait();   // every block has started
  __syncthreads();  // this block's row maxima are complete
  mark(1);
  if ((int)threadIdx.x < kCluster * m) {
    const int q = threadIdx.x / m, r = threadIdx.x % m;
    st_async(remote(amax_all + rank * kMaxRows + r, q), amax_s[r], remote(&bar[0], q));
  }
  sm90::mbar_wait(&bar[0], 0);  // every block's row maxima are in
  mark(2);
  float g = 1.0f;
  if (row < m) {
    amax = 0.0f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) amax = fmaxf(amax, amax_all[q * kMaxRows + row]);
    g = 127.0f / (amax + 1e-5f);
  }
  if (j == 0) gamma_s[row] = g;
  uint32_t* qr = xq + (size_t)row * (p.xq_ld / 4);
  if (row < m) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j + b * tpr >= items) break;
      item_quantize(s.v[b], g, qr + (j + b * tpr) * kWords, s.x);
    }
    for (int i0 = j + tpr * kBatch; i0 < items; i0 += stride) {
      uint4 u[kMore];
#pragma unroll
      for (int b = 0; b < kMore; ++b)
        if (i0 + b * tpr < items) u[b] = __ldg(s.xr + i0 + b * tpr);
#pragma unroll
      for (int b = 0; b < kMore; ++b)
        if (i0 + b * tpr < items) item_quantize(u[b], g, qr + (i0 + b * tpr) * kWords, s.x);
    }
    for (int w = items * kWords + j; w < words; w += tpr) qr[w] = 0u;  // the K tail
  }
  for (int i = threadIdx.x; i < (p.mpad - m) * words; i += kThreads)  // the pad rows
    xq[(size_t)(m + i / words) * (p.xq_ld / 4) + i % words] = 0u;
  mark(3);
}

// k32 steps whose shared loads a warp issues together before their MMAs
constexpr int kUnroll = 4;

template <int NT>
struct Acc {
  int c[2][NT][4];  // [tile][token-row group][fragment]
};

// B fragments of step s for the NT groups of 8 token rows: codes 8t .. 8t+7
// of row 8 i + g.
template <int NT>
__device__ __forceinline__ void b_frags(const uint8_t* xq, int xq_ld, int s, int g, int t,
                                        uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const uint2 v = *reinterpret_cast<const uint2*>(xq + (size_t)(8 * i + g) * xq_ld + 32 * s +
                                                    8 * t);
    b[i][0] = v.x;
    b[i][1] = v.y;
  }
}

template <int NT>
__device__ __forceinline__ void mma_step(const uint32_t (&a)[2][4], const uint32_t (&b)[NT][2],
                                         Acc<NT>& acc) {
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int i = 0; i < NT; ++i) rt::mma_s8(acc.c[tau][i], a[tau], b[i]);
}

// Step 3, 1-bit weight: A of step s from the word of packed row 4 s + t at
// the warp's columns 4 g .. 4 g + 3 (byte 2 tau: A row g of tile tau;
// byte 2 tau + 1: A row g + 8; low nibble quad t, high nibble quad t + 4).
template <int NT>
__device__ __forceinline__ void packed_steps(const uint8_t* w, const uint8_t* xq, int xq_ld,
                                             int steps, Acc<NT>& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint8_t* wl = w + t * kPackedLd + 32 * warp + 4 * g;
  for (int s0 = 0; s0 < steps; s0 += kUnroll) {  // kUnroll steps' loads, then their MMAs
    uint32_t word[kUnroll], b[kUnroll][NT][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u < steps) {
        word[u] = *reinterpret_cast<const uint32_t*>(wl + (size_t)(s0 + u) * 4 * kPackedLd);
        b_frags<NT>(xq, xq_ld, s0 + u, g, t, b[u]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u < steps) {
        uint32_t a[2][4];
#pragma unroll
        for (int tau = 0; tau < 2; ++tau) {
          const uint32_t lo = word[u] >> (16 * tau), hi = lo >> 8;
          a[tau][0] = sm90::sign_word(lo & 0xFu);
          a[tau][1] = sm90::sign_word(hi & 0xFu);
          a[tau][2] = sm90::sign_word((lo >> 4) & 0xFu);
          a[tau][3] = sm90::sign_word((hi >> 4) & 0xFu);
        }
        mma_step<NT>(a, b[u], acc);
      }
  }
}

// Step 3, int8 weight: A of step s from rows 32 s + 8 t + (0..7) of the
// int8 stage at the warp's columns 4 g .. 4 g + 3, transposed 4 x 4 so
// that each word is one column's four K values.
template <int NT>
__device__ __forceinline__ void int8_steps(const uint8_t* w, const uint8_t* xq, int xq_ld,
                                           int steps, Acc<NT>& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // chunk 2 warp + g / 4 of the row, swizzled by 2 t (Int8Swizzle of rows 32 s + 8 t + j)
  const uint8_t* wl = w + (size_t)(8 * t) * kCols + 16 * ((2 * warp + (g >> 2)) ^ (2 * t)) +
                      4 * (g & 3);
  for (int s0 = 0; s0 < steps; s0 += kUnroll) {  // kUnroll steps' loads, then their MMAs
    uint32_t v0[kUnroll][4], v1[kUnroll][4], b[kUnroll][NT][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u < steps) {
        const uint8_t* ws = wl + (size_t)(s0 + u) * 32 * kCols;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v0[u][j] = rt::lds32(reinterpret_cast<const int8_t*>(ws + j * kCols));
          v1[u][j] = rt::lds32(reinterpret_cast<const int8_t*>(ws + (4 + j) * kCols));
        }
        b_frags<NT>(xq, xq_ld, s0 + u, g, t, b[u]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u < steps) {
        uint32_t q0[4], q1[4], a[2][4];
        rt::transpose4x4(v0[u], q0);
        rt::transpose4x4(v1[u], q1);
#pragma unroll
        for (int tau = 0; tau < 2; ++tau) {
          a[tau][0] = q0[2 * tau];
          a[tau][1] = q0[2 * tau + 1];
          a[tau][2] = q1[2 * tau];
          a[tau][3] = q1[2 * tau + 1];
        }
        mma_step<NT>(a, b[u], acc);
      }
  }
}

// Step 4, first half: a warp sends its sums of token row r = 8 i + 2 t + e
// (r < m) to the block of rank r % 8 = 2 t + e, slot
// `rank`, as one st.async of the warp's columns 4 g .. 4 g + 3: 16 bytes
// of int32, or (`narrow`) 8 of int16.
template <int NT>
__device__ __forceinline__ void send_sums(const Acc<NT>& acc, const Plan& p, uint8_t* smem,
                                          int m, int rank, bool narrow) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int* sums = reinterpret_cast<const int*>(smem + p.sums_off);
  const int16_t* sums16 = reinterpret_cast<const int16_t*>(sums);
  const uint64_t* bar = reinterpret_cast<const uint64_t*>(smem + p.bar_off) + 1;
  const auto pack = [](int lo, int hi) { return (uint32_t)(uint16_t)lo | ((uint32_t)hi << 16); };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int owner = 2 * t + e;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (8 * i + owner >= m) continue;
      const int at = (rank * NT + i) * kSumsLd + 32 * warp + 4 * g;
      const int c0 = acc.c[0][i][e], c1 = acc.c[0][i][2 + e], c2 = acc.c[1][i][e],
                c3 = acc.c[1][i][2 + e];
      if (narrow)
        st_async(remote(sums16 + at, owner), make_uint2(pack(c0, c1), pack(c2, c3)),
                 remote(bar, owner));
      else
        st_async(remote(sums + at, owner), make_int4(c0, c1, c2, c3), remote(bar, owner));
    }
  }
}

// Step 4, second half: once the 8 blocks' sums of its rows rank, rank + 8,
// ... < m are in (`mark(0)`), the block adds the 8 slots, one column a
// thread, and writes out[row, col0 + column] = float(sum) * scale(row) for
// columns < ncols (out has row stride ncols).
template <int NT, class Out, class Scale, class Mark = NoMark>
__device__ __forceinline__ void reduce_store(const Plan& p, uint8_t* smem, int m, int rank,
                                             int col0, int ncols, bool narrow,
                                             Out* __restrict__ out, Scale scale,
                                             Mark mark = {}) {
  const int* sums = reinterpret_cast<const int*>(smem + p.sums_off);
  const int16_t* sums16 = reinterpret_cast<const int16_t*>(sums);
  sm90::mbar_wait(reinterpret_cast<uint64_t*>(smem + p.bar_off) + 1, 0);
  mark(0);
  const int col = col0 + (int)threadIdx.x;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int row = rank + kCluster * i;
    if (row < m && col < ncols) {
      int sum = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const int at = (q * NT + i) * kSumsLd + threadIdx.x;
        sum += narrow ? (int)sums16[at] : sums[at];
      }
      rt::store_out(out + (size_t)row * ncols + col, (float)sum * scale(row));
    }
  }
}

}  // namespace repro_gemv
