// Prefill-tier fused first GEMM of the decoupled FFN for Hopper (sm_90a):
// both up-projections of one FFN input (the 1-bit trunk and the r-wide
// 8-bit branch) in one launch, on activations already quantized per token.
//
// Replaces the Pallas kernel src/repro/kernels/decoupled_matmul.py
// (pl.pallas_call in decoupled_matmul, _decoupled_kernel).
//
// What bounds it on an H100: at prefill (M = 8192 rows) the int8
// operations, 2 M K (N + r), over the card's int8 tensor-core rate.
//
// Design.  The TPU kernel walks the trunk's N tiles and pins the whole
// 8-bit weight (r <= bn) beside them, accumulating it on the j == 0 pass
// only, so its sequential grid reads each activation tile once for both
// branches.  Blocks on Hopper run in no order, so one grid holds both
// branches instead: ceil(N / BN) trunk tiles, then ceil(r / BN) tiles of
// the 8-bit branch (any r, no "r fits one tile" rule), each a K loop of
// tile_gemm.cuh.  A trunk block expands packed signs into its [n][k]
// shared tile; an 8-bit block transposes 4 x 4 blocks of the (K, r)
// row-major int8 weight into the same layout.  Every block reads its
// activation rows, mostly from L2.  Epilogues in the Pallas kernel's
// order of operations, f32 with IEEE division, written in out_dtype:
//   y1 = float(acc1) * ((beta * lam) * (1 / gamma))
//   y8 = float(acc8) * (alpha / (gamma * w8scale))
// so both outputs equal the plain version's bit for bit.

#include "tile_gemm.cuh"

using namespace repro_tile;

namespace {

template <int BM, int BN, class Out>
__global__ void __launch_bounds__(kThreads)
decoupled_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                        const int8_t* __restrict__ w8, const float* __restrict__ gamma,
                        const float* __restrict__ lam_p, const float* __restrict__ w8s_p,
                        const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
                        Out* __restrict__ y1, Out* __restrict__ y8, int m, int k, int n, int r) {
  __shared__ Smem<BM, BN> sm;
  const int row0 = blockIdx.y * BM;
  const int trunk_tiles = (n + BN - 1) / BN;
  Acc<BM, BN> acc;
  if ((int)blockIdx.x < trunk_tiles) {
    const int col0 = blockIdx.x * BN;
    PackedB<BN> b{wp, n, k / 8, col0};
    gemm_tile<BM, BN>(sm, x, m, k, row0, b, acc);
    const float bl = *beta_p * *lam_p;
    store_tile<BM, BN>(acc, row0, col0, m, n, y1, n,
                       [&](int row) { return bl * (1.0f / gamma[row]); });
  } else {
    const int col0 = (blockIdx.x - trunk_tiles) * BN;
    Int8B<BN> b{w8, r, k, col0};
    gemm_tile<BM, BN>(sm, x, m, k, row0, b, acc);
    const float alpha = *alpha_p, w8s = *w8s_p;
    store_tile<BM, BN>(acc, row0, col0, m, r, y8, r,
                       [&](int row) { return alpha / (gamma[row] * w8s); });
  }
}

template <int BM, int BN, class Out>
cudaError_t launch(const int8_t* x, const uint8_t* wp, const int8_t* w8, const float* gamma,
                   const float* const* sc, void* y1, void* y8, int m, int k, int n, int r,
                   cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN + (r + BN - 1) / BN, (m + BM - 1) / BM);
  decoupled_matmul_kernel<BM, BN, Out><<<grid, kThreads, 0, stream>>>(
      x, wp, w8, gamma, sc[0], sc[1], sc[2], sc[3], static_cast<Out*>(y1), static_cast<Out*>(y8),
      m, k, n, r);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_typed(int out_dtype, const int8_t* x, const uint8_t* wp, const int8_t* w8,
                         const float* gamma, const float* const* sc, void* y1, void* y8, int m,
                         int k, int n, int r, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<BM, BN, float>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s);
    case kBF16: return launch<BM, BN, __nv_bfloat16>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): x (m, k) i8, wp (k/8, n) u8,
// w8 (k, r) i8, gamma (m,) f32, lam / w8scale / alpha / beta one f32 each,
// y1 (m, n) and y8 (m, r) of out_dtype (0 f32, 1 bf16), all device
// pointers; k a multiple of 16, r a multiple of 4, x 16-byte and w8 4-byte
// aligned.  Returns the cudaError_t of the launch and never synchronizes.
extern "C" int decoupled_matmul_launch(const int8_t* x, const uint8_t* wp, const int8_t* w8,
                                       const float* gamma, const float* lam, const float* w8scale,
                                       const float* alpha, const float* beta, void* y1, void* y8,
                                       int out_dtype, int m, int k, int n, int r, int device,
                                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (m < 1 || n < 1 || r < 1 || r % 4 || k < 16 || k % 16))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const float* sc[4] = {lam, w8scale, alpha, beta};
    const cudaStream_t s = (cudaStream_t)stream;
    e = big_tiles(m, n + r, device)
            ? launch_typed<128, 128>(out_dtype, x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s)
            : launch_typed<64, 64>(out_dtype, x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
