// Shared pieces of the decode-tier integer GEMV kernels (w1a8_gemv.cu,
// int8_matmul.cu).
//
// Block shape, common to all three kernels: 8 warps (256 threads) own 32
// packed output columns, one column per lane (or 8 int8 columns, four
// lanes per column: see int8_columns_split).  The 8 warps split the reduction
// (K) axis into 8 slices and meet in shared memory, where each of the 256
// threads sums one (row, column) pair of a group of 8 token rows and
// applies the epilogue.  The token rows live in shared memory as int8
// (M x K, rows padded to a multiple of 8 with zero codes and unit scale —
// the kernel takes any M, so the wrapper never pads).  Every lane of a warp
// reads the same activation word at a time (a shared-memory broadcast) and
// its own weight byte (one 32-byte sector per warp), and multiplies four
// int8 pairs per __dp4a into an int32 accumulator.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowGroup = 8;  // token rows accumulated per pass over the K slice
constexpr int kCols = 32;     // output columns per block
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

// Four sign bits (bit j -> weight j) as four int8 lanes of +1 (bit set) or -1.
__device__ __forceinline__ int nibble_signs(uint32_t nib) {
  const uint32_t ones = (nib * 0x00204081u) & 0x01010101u;  // bit j -> byte j, 0 or 1
  return (int)__vsub4(ones << 1, 0x01010101u);               // 0 / 2 -> -1 / +1 per byte
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float g) {
  const auto q = [g](float f) {
    return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(f * g), -127.0f), 127.0f);
  };
  return q(v.x) | (q(v.y) << 8) | (q(v.z) << 16) | (q(v.w) << 24);
}

// Loads each lane keeps in flight: global-memory latency, not bandwidth,
// bounds these small GEMVs, so every loop issues a batch of independent
// loads into registers before it uses any of them.
constexpr int kInFlight = 8;

// Four consecutive activations of a row as floats: one 16-byte load of
// f32, or one 8-byte load of bf16 (bf16 -> f32 is exact).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int i) {
  return __ldg(reinterpret_cast<const float4*>(row) + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ row, int i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + i);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

// Per-token AbsMax INT8 quantization of x (m x k, f32 or bf16, row-major,
// 16-byte aligned, k a multiple of 8) into shared memory, one warp per
// row, four values per load, each cast to f32 as it is read: gamma = 127 /
// (max|x| + 1e-5) with IEEE division, codes = clip(rint(x * gamma), -127,
// 127) with round-half-even — exactly core.quantization.act_scale_int8 /
// quantize_act_int8.  Rows m..mpad-1 get zero codes and unit scale.
template <class In>
__device__ inline void quantize_rows(const In* __restrict__ x, int m, int k, int mpad,
                                     int8_t* xq, float* gamma) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k4 = k >> 2;
  for (int row = warp; row < mpad; row += kWarps) {
    uint32_t* q = reinterpret_cast<uint32_t*>(xq + (size_t)row * k);
    if (row >= m) {
      for (int i = lane; i < k4; i += 32) q[i] = 0u;
      if (lane == 0) gamma[row] = 1.0f;
      continue;
    }
    const In* xr = x + (size_t)row * k;
    float amax = 0.0f;
    for (int i0 = lane; i0 < k4; i0 += 32 * kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        v[j] = i0 + 32 * j < k4 ? load4(xr, i0 + 32 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) amax = fmaxf(amax, abs_max4(v[j]));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float g = 127.0f / (amax + 1e-5f);
    if (lane == 0) gamma[row] = g;
    for (int i0 = lane; i0 < k4; i0 += 32 * kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (i0 + 32 * j < k4) v[j] = load4(xr, i0 + 32 * j);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (i0 + 32 * j < k4) q[i0 + 32 * j] = quantize4(v[j], g);
    }
  }
}

// Copy already-quantized int8 rows (m x k) into shared memory, zeroing the pad rows.
__device__ inline void load_rows(const int8_t* __restrict__ x, int m, int k, int mpad, int8_t* xq) {
  const size_t real = (size_t)m * k, all = (size_t)mpad * k;
  for (size_t i = threadIdx.x; i < all; i += kThreads) xq[i] = i < real ? x[i] : (int8_t)0;
}

// acc[i] += sum over packed K-bytes [kb_lo, kb_hi) of xq[row0 + i, 8kb + b] * sign(col, 8kb + b),
// for the packed sign matrix wp (k/8 x n_cols, uint8, row-major).
__device__ __forceinline__ void packed_column(const uint8_t* __restrict__ wp, int n_cols, int col,
                                              int kb_lo, int kb_hi, const int8_t* xq, int k,
                                              int row0, int (&acc)[kRowGroup]) {
  constexpr int kBatch = 2 * kInFlight;
  for (int kb0 = kb_lo; kb0 < kb_hi; kb0 += kBatch) {
    uint32_t bytes[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      bytes[j] = kb0 + j < kb_hi ? __ldg(wp + (size_t)(kb0 + j) * n_cols + col) : 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      // a guard, not a break: the loop must unroll fully so that `bytes`
      // stays in registers (a zero byte would read as eight -1 signs)
      if (kb0 + j < kb_hi) {
        const int lo = nibble_signs(bytes[j] & 0xFu), hi = nibble_signs(bytes[j] >> 4);
        const int8_t* xk = xq + (size_t)row0 * k + (size_t)(kb0 + j) * 8;
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          const int2 xw = *reinterpret_cast<const int2*>(xk + (size_t)i * k);
          acc[i] = __dp4a(xw.x, lo, acc[i]);
          acc[i] = __dp4a(xw.y, hi, acc[i]);
        }
      }
    }
  }
}

// acc[i] += sum over k in [4 k4_lo, 4 k4_hi) of xq[row0 + i, k] * w[k, col],
// for the int8 matrix w (k x n_cols, row-major): four weights down K make
// one word.  (Batching these loads like packed_column's measured slower on
// an H100: 10.0 against 6.5 us for int8_matmul at M = 4; see PERF.md.)
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
