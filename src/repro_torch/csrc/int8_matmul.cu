// W8A8 matmul for Hopper (sm_90a): the decoupled FFN's 8-bit down
// projection (w8_down), on activations already quantized per token.
//
// Replaces the Pallas kernel src/repro/kernels/int8_matmul.py (pl.pallas_call
// in int8_matmul, _int8_kernel).
//
// What bounds it on an H100: the weight bytes.  At the decode shapes
// (M <= 32 rows against w8_down's 384 x 2048 int8 = 768 KB) every weight
// byte is used by at most 2 M integer operations, far below the ~590 per
// byte at which the tensor cores, not memory, would be the limit.
//
// Design: the GEMV block of gemv_common.cuh.  Each block copies up to 32
// int8 token rows (blockIdx.y picks the row tile, so any M runs) into
// shared memory and owns 8 output columns, four lanes to a column; a lane
// gathers four int8 weights of its column down K into one word and feeds
// one __dp4a per token row.  The epilogue keeps the Pallas kernel's order
// of operations, y = float(acc) * (1 / (gamma * wscale)), so the f32 output
// equals the plain version bit for bit (no fast math).

#include "gemv_common.cuh"

using namespace repro;

namespace {

constexpr int kRowTile = 32;  // token rows per block (blockIdx.y)

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ gamma, const float* __restrict__ wscale_p,
                   float* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int base = blockIdx.y * kRowTile;
  const int mt = min(kRowTile, m - base);
  const SmemPlan p = smem_plan(mt, k);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  int* part = reinterpret_cast<int*>(smem + p.part_off);

  load_rows(x + (size_t)base * k, mt, k, p.mpad, xq);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kInt8Cols, col = col0 + lane;
  int lo, hi;
  warp_slice(k / 4, warp, lo, hi);
  const float wscale = *wscale_p;
  for (int row0 = 0; row0 < p.mpad; row0 += kRowGroup) {
    int acc[kRowGroup] = {};
    int8_columns_split(w, n, col0, lo, hi, xq, k, row0, acc);
    const int sum = reduce_warps(acc, part);
    const int row = row0 + warp;
    if (lane < kInt8Cols && row < mt && col < n) {
      const float inv = 1.0f / (gamma[base + row] * wscale);
      out[(size_t)(base + row) * n + col] = (float)sum * inv;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): x (m, k) i8, w (k, n) i8,
// gamma (m,) f32, wscale one f32, out (m, n) f32, all device pointers;
// k must be a multiple of 4.  Returns the cudaError_t of the launch and
// never synchronizes.
extern "C" int int8_matmul_launch(const int8_t* x, const int8_t* w, const float* gamma,
                                  const float* wscale, float* out, int m, int k, int n,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const SmemPlan p = smem_plan(m < kRowTile ? m : kRowTile, k);
  if (e == cudaSuccess && (m < 1 || k % 4 || p.total > kMaxSmem)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = allow_smem(int8_matmul_kernel, p.total);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid((n + kInt8Cols - 1) / kInt8Cols, (m + kRowTile - 1) / kRowTile);
  int8_matmul_kernel<<<grid, kThreads, p.total, (cudaStream_t)stream>>>(x, w, gamma, wscale, out,
                                                                       m, k, n);
  return (int)cudaGetLastError();
}
