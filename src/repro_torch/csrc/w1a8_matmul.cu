// Prefill-tier W1A8 GEMM for Hopper (sm_90a): the packed 1-bit linears
// (q/k/v/o and the FFN's w1_down) above the decode tier's 32 rows, on
// activations already quantized per token.
//
// Replaces the Pallas kernel src/repro/kernels/w1a8_matmul.py (pl.pallas_call
// in w1a8_matmul, _w1a8_kernel).
//
// What bounds it on an H100: at prefill (M = 8192 rows of a 128-token batch
// of 64) the int8 operations, 2 M K N, over the card's int8 tensor-core
// rate; each packed weight byte feeds 16 M operations and the activations
// are read once per column tile, far past the ~590 operations per byte of
// device memory where the bytes would bind.
//
// Design.  The TPU kernel walks a sequential (M, N, K) grid and carries
// the int32 accumulator in VMEM from one K step to the next.  Here each
// block owns one output tile and loops over K itself (tile_gemm.cuh):
// mma.sync m16n8k32 on int8, cp.async for the activation tile, the packed
// signs expanded to +-1 int8 in a [n][k] shared tile.  The TPU kernel
// needs M, N and K padded to its tiles; here ragged rows, columns and the
// K tail are guarded or zero-filled in the kernel, so the wrapper never
// pads.  The epilogue keeps the Pallas kernel's order of operations,
//   y = float(acc) * (lam * (1 / gamma))
// in f32 with IEEE division (no fast math), and writes out_dtype directly
// (f32, or bf16 rounded to nearest even), so the output equals the
// plain version's bit for bit.

#include "tile_gemm.cuh"

using namespace repro_tile;

namespace {

template <int BM, int BN, class Out>
__global__ void __launch_bounds__(kThreads)
w1a8_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                   const float* __restrict__ gamma, const float* __restrict__ lam_p,
                   Out* __restrict__ out, int m, int k, int n) {
  __shared__ Smem<BM, BN> sm;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  PackedB<BN> b{wp, n, k / 8, col0};
  Acc<BM, BN> acc;
  gemm_tile<BM, BN>(sm, x, m, k, row0, b, acc);
  const float lam = *lam_p;
  store_tile<BM, BN>(acc, row0, col0, m, n, out, n,
                     [&](int row) { return lam * (1.0f / gamma[row]); });
}

template <int BM, int BN, class Out>
cudaError_t launch(const int8_t* x, const uint8_t* wp, const float* gamma, const float* lam,
                   void* out, int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w1a8_matmul_kernel<BM, BN, Out>
      <<<grid, kThreads, 0, stream>>>(x, wp, gamma, lam, static_cast<Out*>(out), m, k, n);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_typed(int out_dtype, const int8_t* x, const uint8_t* wp, const float* gamma,
                         const float* lam, void* out, int m, int k, int n, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<BM, BN, float>(x, wp, gamma, lam, out, m, k, n, s);
    case kBF16: return launch<BM, BN, __nv_bfloat16>(x, wp, gamma, lam, out, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): x (m, k) i8, wp (k/8, n) u8,
// gamma (m,) f32, lam one f32, out (m, n) of out_dtype (0 f32, 1 bf16),
// all device pointers; k a multiple of 16, x 16-byte aligned.  Returns
// the cudaError_t of the launch and never synchronizes.
extern "C" int w1a8_matmul_launch(const int8_t* x, const uint8_t* wp, const float* gamma,
                                  const float* lam, void* out, int out_dtype, int m, int k, int n,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (m < 1 || n < 1 || k < 16 || k % 16)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    e = big_tiles(m, n, device)
            ? launch_typed<128, 128>(out_dtype, x, wp, gamma, lam, out, m, k, n, s)
            : launch_typed<64, 64>(out_dtype, x, wp, gamma, lam, out, m, k, n, s);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
