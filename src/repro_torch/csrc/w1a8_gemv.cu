// Decode-tier W1A8 GEMV kernels with fused activation quantization, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/w1a8_gemv.py:
//   w1a8_gemv       (pl.pallas_call in w1a8_gemv, _w1a8_gemv_kernel)
//   decoupled_gemv  (pl.pallas_call in decoupled_gemv, _decoupled_gemv_kernel)
//
// What bounds them on an H100: the weight bytes.  A decode step multiplies
// M <= 32 token rows by the whole packed sign matrix (K/8 x N bytes) and,
// for decoupled_gemv, by the int8 branch (K x r bytes); at M = 4 there are
// 64 int8 operations per weight byte, far below the card's ~590 operations
// per byte of device memory, so time is bytes over bandwidth at best.
//
// Design.  The TPU kernel quantizes the activations once, at grid step
// (0, 0), and leaves the int8 rows in VMEM for every later step of its
// sequential grid.  Blocks on Hopper run in parallel and in no order, so
// here every block quantizes the M rows itself into shared memory (at most
// 32 x 5024 int8 = 157 KB plus scales and partial sums, under the 227 KB a
// block may use) — one launch per call, at the price of each block reading
// the f32 activations (from L2 after the first block).  Each block then
// owns 32 output columns (see gemv_common.cuh): lane n reads its column's
// packed byte, expands the 8 sign bits to two words of four +-1 int8 lanes
// and feeds two __dp4a per token row.  decoupled_gemv puts the r int8
// columns after the N packed columns in one grid, 8 to a block (an int8
// column holds 8x the bytes of a packed one), so one launch reads the
// activations once per block and the int8 weight exactly once.
//
// Epilogues keep the Pallas kernels' order of operations, so the f32
// outputs equal the plain versions bit for bit (no fast math: IEEE division
// and round-half-even throughout):
//   w1a8_gemv       y  = float(acc)  * (lam / gamma)
//   decoupled_gemv  y1 = float(acc1) * ((beta * lam) / gamma)
//                   y8 = float(acc8) * (alpha / (gamma * w8scale))

#include "gemv_common.cuh"

using namespace repro;

namespace {

__global__ void __launch_bounds__(kThreads)
w1a8_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                 const float* __restrict__ lam_p, float* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemPlan p = smem_plan(m, k);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* gamma = reinterpret_cast<float*>(smem + p.gamma_off);
  int* part = reinterpret_cast<int*>(smem + p.part_off);

  quantize_rows(x, m, k, p.mpad, xq, gamma);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCols + lane;
  int lo, hi;
  warp_slice(k / 8, warp, lo, hi);
  const float lam = *lam_p;
  for (int row0 = 0; row0 < p.mpad; row0 += kRowGroup) {
    int acc[kRowGroup] = {};
    if (col < n) packed_column(wp, n, col, lo, hi, xq, k, row0, acc);
    const int sum = reduce_warps(acc, part);
    const int row = row0 + warp;
    if (row < m && col < n) {
      const float s = lam / gamma[row];
      out[(size_t)row * n + col] = (float)sum * s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decoupled_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                      const int8_t* __restrict__ w8, const float* __restrict__ lam_p,
                      const float* __restrict__ w8s_p, const float* __restrict__ alpha_p,
                      const float* __restrict__ beta_p, float* __restrict__ y1,
                      float* __restrict__ y8, int m, int k, int n, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemPlan p = smem_plan(m, k);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* gamma = reinterpret_cast<float*>(smem + p.gamma_off);
  int* part = reinterpret_cast<int*>(smem + p.part_off);

  quantize_rows(x, m, k, p.mpad, xq, gamma);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks1 = (n + kCols - 1) / kCols;
  int lo, hi;
  if ((int)blockIdx.x < blocks1) {  // 1-bit trunk columns (block-uniform branch)
    const int col = blockIdx.x * kCols + lane;
    warp_slice(k / 8, warp, lo, hi);
    const float bl = *beta_p * *lam_p;
    for (int row0 = 0; row0 < p.mpad; row0 += kRowGroup) {
      int acc[kRowGroup] = {};
      if (col < n) packed_column(wp, n, col, lo, hi, xq, k, row0, acc);
      const int sum = reduce_warps(acc, part);
      const int row = row0 + warp;
      if (row < m && col < n) {
        const float s = bl / gamma[row];
        y1[(size_t)row * n + col] = (float)sum * s;
      }
    }
  } else {  // r-wide int8 branch columns
    const int col0 = (blockIdx.x - blocks1) * kInt8Cols, col = col0 + lane;
    warp_slice(k / 4, warp, lo, hi);
    const float alpha = *alpha_p, w8s = *w8s_p;
    for (int row0 = 0; row0 < p.mpad; row0 += kRowGroup) {
      int acc[kRowGroup] = {};
      int8_columns_split(w8, r, col0, lo, hi, xq, k, row0, acc);
      const int sum = reduce_warps(acc, part);
      const int row = row0 + warp;
      if (lane < kInt8Cols && row < m && col < r) {
        const float inv8 = alpha / (gamma[row] * w8s);
        y8[(size_t)row * r + col] = (float)sum * inv8;
      }
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns the cudaError_t of its launch
// (0 on success) and never synchronizes.  Shapes: x (m, k) f32, wp (k/8, n)
// u8, w8 (k, r) i8, scalars one f32 each, outputs (m, n) and (m, r) f32;
// k must be a multiple of 8.

extern "C" int w1a8_gemv_launch(const float* x, const uint8_t* wp, const float* lam, float* out,
                                int m, int k, int n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const SmemPlan p = smem_plan(m, k);
  if (e == cudaSuccess && (m < 1 || k % 8 || p.total > kMaxSmem)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = allow_smem(w1a8_gemv_kernel, p.total);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid((n + kCols - 1) / kCols);
  w1a8_gemv_kernel<<<grid, kThreads, p.total, (cudaStream_t)stream>>>(x, wp, lam, out, m, k, n);
  return (int)cudaGetLastError();
}

extern "C" int decoupled_gemv_launch(const float* x, const uint8_t* wp, const int8_t* w8,
                                     const float* lam, const float* w8scale, const float* alpha,
                                     const float* beta, float* y1, float* y8, int m, int k,
                                     int n, int r, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const SmemPlan p = smem_plan(m, k);
  if (e == cudaSuccess && (m < 1 || k % 8 || p.total > kMaxSmem)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = allow_smem(decoupled_gemv_kernel, p.total);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid((n + kCols - 1) / kCols + (r + kInt8Cols - 1) / kInt8Cols);
  decoupled_gemv_kernel<<<grid, kThreads, p.total, (cudaStream_t)stream>>>(
      x, wp, w8, lam, w8scale, alpha, beta, y1, y8, m, k, n, r);
  return (int)cudaGetLastError();
}
