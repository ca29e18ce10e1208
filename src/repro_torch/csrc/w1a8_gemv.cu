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
// As upstream, x is read in its own type (f32 or bf16, cast to f32 as it
// is loaded, which is exact) and the outputs are written in out_dtype (f32,
// or bf16 rounded to nearest even from the f32 epilogue), so a bf16 model
// pays no cast on either side.  Epilogues keep the Pallas kernels' order
// of operations, so the outputs equal the plain versions bit for bit (no
// fast math: IEEE division and round-half-even throughout):
//   w1a8_gemv       y  = float(acc)  * (lam / gamma)
//   decoupled_gemv  y1 = float(acc1) * ((beta * lam) / gamma)
//                   y8 = float(acc8) * (alpha / (gamma * w8scale))

#include "gemv_common.cuh"
#include "tile_gemm.cuh"

using namespace repro;
namespace rt = repro_tile;

namespace {

template <class In, class Out>
__global__ void __launch_bounds__(kThreads)
w1a8_gemv_kernel(const In* __restrict__ x, const uint8_t* __restrict__ wp,
                 const float* __restrict__ lam_p, Out* __restrict__ out, int m, int k, int n) {
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
      rt::store_out(out + (size_t)row * n + col, (float)sum * s);
    }
  }
}

template <class In, class Out>
__global__ void __launch_bounds__(kThreads)
decoupled_gemv_kernel(const In* __restrict__ x, const uint8_t* __restrict__ wp,
                      const int8_t* __restrict__ w8, const float* __restrict__ lam_p,
                      const float* __restrict__ w8s_p, const float* __restrict__ alpha_p,
                      const float* __restrict__ beta_p, Out* __restrict__ y1,
                      Out* __restrict__ y8, int m, int k, int n, int r) {
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
        rt::store_out(y1 + (size_t)row * n + col, (float)sum * s);
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
        rt::store_out(y8 + (size_t)row * r + col, (float)sum * inv8);
      }
    }
  }
}

template <class In, class Out>
cudaError_t launch_w1a8(const void* x, const uint8_t* wp, const float* lam, void* out, int m,
                        int k, int n, size_t smem, cudaStream_t s) {
  const auto kernel = w1a8_gemv_kernel<In, Out>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + kCols - 1) / kCols), kThreads, smem, s>>>(
      static_cast<const In*>(x), wp, lam, static_cast<Out*>(out), m, k, n);
  return cudaGetLastError();
}

template <class In, class Out>
cudaError_t launch_decoupled(const void* x, const uint8_t* wp, const int8_t* w8,
                             const float* lam, const float* w8scale, const float* alpha,
                             const float* beta, void* y1, void* y8, int m, int k, int n, int r,
                             size_t smem, cudaStream_t s) {
  const auto kernel = decoupled_gemv_kernel<In, Out>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kCols - 1) / kCols + (r + kInt8Cols - 1) / kInt8Cols);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const In*>(x), wp, w8, lam, w8scale, alpha,
                                      beta, static_cast<Out*>(y1), static_cast<Out*>(y8), m, k,
                                      n, r);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// The (x, output) type pair of a launch as 0-3 (x major; each code 0 f32,
// 1 bf16, as rt::OutCode), or -1 for a code the kernels do not take.
inline int types(int x_dtype, int out_dtype) {
  const auto ok = [](int c) { return c == rt::kF32 || c == rt::kBF16; };
  return ok(x_dtype) && ok(out_dtype) ? 2 * x_dtype + out_dtype : -1;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns the cudaError_t of its launch
// (0 on success) and never synchronizes.  Shapes: x (m, k) of x_dtype, 16-
// byte aligned, wp (k/8, n) u8, w8 (k, r) i8, scalars one f32 each, outputs
// (m, n) and (m, r) of out_dtype (dtype codes: 0 f32, 1 bf16); k must be a
// multiple of 8.

extern "C" int w1a8_gemv_launch(const void* x, int x_dtype, const uint8_t* wp, const float* lam,
                                void* out, int out_dtype, int m, int k, int n, int device,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const SmemPlan p = smem_plan(m, k);
  if (e == cudaSuccess && (m < 1 || k % 8 || p.total > kMaxSmem)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (types(x_dtype, out_dtype)) {
      case 0: e = launch_w1a8<float, float>(x, wp, lam, out, m, k, n, p.total, s); break;
      case 1: e = launch_w1a8<float, bf16>(x, wp, lam, out, m, k, n, p.total, s); break;
      case 2: e = launch_w1a8<bf16, float>(x, wp, lam, out, m, k, n, p.total, s); break;
      case 3: e = launch_w1a8<bf16, bf16>(x, wp, lam, out, m, k, n, p.total, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

extern "C" int decoupled_gemv_launch(const void* x, int x_dtype, const uint8_t* wp,
                                     const int8_t* w8, const float* lam, const float* w8scale,
                                     const float* alpha, const float* beta, void* y1, void* y8,
                                     int out_dtype, int m, int k, int n, int r, int device,
                                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const SmemPlan p = smem_plan(m, k);
  if (e == cudaSuccess && (m < 1 || k % 8 || p.total > kMaxSmem)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LAUNCH(In, Out) \
  launch_decoupled<In, Out>(x, wp, w8, lam, w8scale, alpha, beta, y1, y8, m, k, n, r, p.total, s)
    switch (types(x_dtype, out_dtype)) {
      case 0: e = REPRO_LAUNCH(float, float); break;
      case 1: e = REPRO_LAUNCH(float, bf16); break;
      case 2: e = REPRO_LAUNCH(bf16, float); break;
      case 3: e = REPRO_LAUNCH(bf16, bf16); break;
      default: e = cudaErrorInvalidValue;
    }
#undef REPRO_LAUNCH
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
