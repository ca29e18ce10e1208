// Fused RMSNorm and per-token AbsMax INT8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm_quant.py
// (pl.pallas_call in rmsnorm_quant, _rmsnorm_quant_kernel).
//
// What bounds it on an H100: the bytes.  Each row is read once (2 or 4
// bytes a value) and written once as int8 plus one f32 scale, with a few
// float operations per value, so time is bytes over bandwidth at best.
//
// Design.  The TPU kernel holds a (bm, D) row block in VMEM.  Here one
// block of 256 threads owns one row: it reads the row once into shared
// memory as f32 (D floats, dynamic shared memory) while summing squares,
// reduces across the block (warp shuffles, then the 8 warp partials),
// scales the row in shared memory while taking its AbsMax, reduces again,
// and writes the codes.  The arithmetic follows the Pallas body:
//   normed = x * rsqrt(mean(x^2) + eps) * scale
//   gamma  = 127 / (max|normed| + 1e-5)   (IEEE division)
//   q      = clip(rint(normed * gamma), -127, 127)
// It is not bit-exact against the plain version, by construction: the sum
// of squares runs in another order than torch's, and rsqrtf is not
// correctly rounded (neither is lax.rsqrt), so normed may differ in its
// last bits and a value on a rounding boundary may take the neighbouring
// code.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

enum InCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The block-wide sum (kind 0) or max (kind 1) of v, returned to every
// thread.  `red` holds kWarps floats; the call ends with a barrier.
template <int kind>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kind == 0 ? v + u : fmaxf(v, u);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = kind == 0 ? v + red[w] : fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

template <class In>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quant_kernel(const In* __restrict__ x, const float* __restrict__ scale,
                     int8_t* __restrict__ q, float* __restrict__ gamma, int d, float eps) {
  extern __shared__ float row_buf[];
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const In* xr = x + row * d;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    row_buf[i] = v;
    ss += v * v;
  }
  const float var = block_reduce<0>(ss, red) / (float)d;
  const float inv_rms = rsqrtf(var + eps);

  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float nv = row_buf[i] * inv_rms * scale[i];
    row_buf[i] = nv;
    amax = fmaxf(amax, fabsf(nv));
  }
  const float g = 127.0f / (block_reduce<1>(amax, red) + 1e-5f);

  int8_t* qr = q + row * d;
  for (int i = threadIdx.x; i < d; i += kThreads)
    qr[i] = (int8_t)fminf(fmaxf(rintf(row_buf[i] * g), -127.0f), 127.0f);
  if (threadIdx.x == 0) gamma[row] = g;
}

template <class In>
cudaError_t launch(const void* x, const float* scale, int8_t* q, float* gamma, int m, int d,
                   float eps, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_quant_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_quant_kernel<In><<<m, kThreads, smem, stream>>>(static_cast<const In*>(x), scale, q,
                                                           gamma, d, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): x (m, d) of in_dtype (0 f32,
// 1 bf16), scale (d,) f32, q (m, d) i8, gamma (m,) f32, all device
// pointers.  Returns the cudaError_t of the launch and never synchronizes.
extern "C" int rmsnorm_quant_launch(const void* x, const float* scale, int8_t* q, float* gamma,
                                    int in_dtype, int m, int d, float eps, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (m < 1 || d < 1 || (size_t)d * sizeof(float) > kMaxSmem))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (in_dtype) {
      case kF32: e = launch<float>(x, scale, q, gamma, m, d, eps, s); break;
      case kBF16: e = launch<__nv_bfloat16>(x, scale, q, gamma, m, d, eps, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
