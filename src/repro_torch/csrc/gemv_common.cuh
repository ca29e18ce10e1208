// The int8 GEMV block of int8_matmul.cu (its route at M <= 32 rows).
//
// Block shape: 8 warps (256 threads) own 8 int8 output columns, four lanes
// per column (see int8_columns_split).  The 8 warps split the reduction
// (K) axis into 8 slices and meet in shared memory, where each of the 256
// threads sums one (row, column) pair of a group of 8 token rows and
// applies the epilogue.  The token rows live in shared memory as int8
// (M x K, rows padded to a multiple of 8 with zero codes — the kernel
// takes any M, so the wrapper never pads).  Every lane of a warp reads the
// same activation word at a time (a shared-memory broadcast) and
// multiplies four int8 pairs per __dp4a into an int32 accumulator.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowGroup = 8;  // token rows accumulated per pass over the K slice
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
static_assert(kThreads / 32 == kRowGroup, "one warp per row of a row group in the epilogue");

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// Byte offsets of one block's shared memory: int8 rows (mpad x k), their
// scales (mpad floats), and the per-warp partial sums of one row group.
struct SmemPlan {
  int mpad;
  size_t gamma_off, part_off, total;
};

__host__ __device__ inline SmemPlan smem_plan(int m, int k) {
  SmemPlan p;
  p.mpad = (int)round_up((size_t)m, kRowGroup);
  p.gamma_off = round_up((size_t)p.mpad * k, 16);
  p.part_off = p.gamma_off + round_up((size_t)p.mpad * sizeof(float), 16);
  p.total = p.part_off + (size_t)kWarps * kRowGroup * 32 * sizeof(int);
  return p;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The half-open slice [lo, hi) of `total` reduction steps that warp `warp` owns.
__device__ __forceinline__ void warp_slice(int total, int warp, int& lo, int& hi) {
  const int per = (total + kWarps - 1) / kWarps;
  lo = min(total, warp * per);
  hi = min(total, lo + per);
}

// Copy already-quantized int8 rows (m x k) into shared memory, zeroing the pad rows.
__device__ inline void load_rows(const int8_t* __restrict__ x, int m, int k, int mpad, int8_t* xq) {
  const size_t real = (size_t)m * k, all = (size_t)mpad * k;
  for (size_t i = threadIdx.x; i < all; i += kThreads) xq[i] = i < real ? x[i] : (int8_t)0;
}

// acc[i] += sum over k in [4 k4_lo, 4 k4_hi) of xq[row0 + i, k] * w[k, col],
// for the int8 matrix w (k x n_cols, row-major): four weights down K make
// one word.  (Batching these loads, eight in flight a lane, measured slower
// on an H100: 10.0 against 6.5 us for int8_matmul at M = 4; see PERF.md.)
__device__ __forceinline__ void int8_column(const int8_t* __restrict__ w, int n_cols, int col,
                                            int k4_lo, int k4_hi, const int8_t* xq, int k,
                                            int row0, int (&acc)[kRowGroup]) {
#pragma unroll 4
  for (int k4 = k4_lo; k4 < k4_hi; ++k4) {
    const int8_t* wc = w + (size_t)(4 * k4) * n_cols + col;
    const uint32_t b0 = (uint8_t)__ldg(wc), b1 = (uint8_t)__ldg(wc + n_cols),
                   b2 = (uint8_t)__ldg(wc + 2 * (size_t)n_cols),
                   b3 = (uint8_t)__ldg(wc + 3 * (size_t)n_cols);
    const int wv = (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      const int xw = *reinterpret_cast<const int*>(xq + (size_t)(row0 + i) * k + (size_t)k4 * 4);
      acc[i] = __dp4a(xw, wv, acc[i]);
    }
  }
}

// int8 columns per block: four lanes share a column (lane = 8 * part + c),
// each taking a quarter of the warp's K slice.  An int8 column is 8x the
// bytes of a packed one, so it gets 4x the threads.
constexpr int kInt8Cols = 8;

// int8_column over columns col0 + (lane & 7), with K split four ways
// across the lanes that share a column; on return every lane holds its
// column's sum over the warp's whole slice [k4_lo, k4_hi).
__device__ __forceinline__ void int8_columns_split(const int8_t* __restrict__ w, int n_cols,
                                                   int col0, int k4_lo, int k4_hi,
                                                   const int8_t* xq, int k, int row0,
                                                   int (&acc)[kRowGroup]) {
  const int lane = threadIdx.x & 31, col = col0 + (lane & 7), part = lane >> 3;
  const int per = (k4_hi - k4_lo + 3) / 4;
  const int lo = min(k4_hi, k4_lo + part * per), hi = min(k4_hi, lo + per);
  if (col < n_cols) int8_column(w, n_cols, col, lo, hi, xq, k, row0, acc);
#pragma unroll
  for (int i = 0; i < kRowGroup; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
}

// Sum the 8 warps' partials: returns, for the calling thread, the full
// int32 accumulator of row (row0 + warp) and column (its lane).  Leaves
// `part` free for the next row group (ends with a barrier).
__device__ __forceinline__ int reduce_warps(const int (&acc)[kRowGroup], int* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowGroup; ++i) part[(warp * kRowGroup + i) * 32 + lane] = acc[i];
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) sum += part[(v * kRowGroup + warp) * 32 + lane];
  __syncthreads();
  return sum;
}

}  // namespace repro
