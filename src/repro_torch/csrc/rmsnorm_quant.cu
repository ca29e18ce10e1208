// Fused RMSNorm and per-token AbsMax INT8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm_quant.py:51
// (pl.pallas_call in rmsnorm_quant; body _rmsnorm_quant_kernel).
//
// What bounds it on an H100: the bytes.  Each row is read once (2 or 4
// bytes a value) and written once as int8 plus one f32 scale, with a few
// float operations per value, so time is bytes over bandwidth at best.
//
// The arithmetic follows the Pallas body on both routes:
//   normed = (x * rsqrt(mean(x^2) + eps)) * scale
//   gamma  = 127 / (max|normed| + 1e-5)   (IEEE division)
//   q      = clip(rint(normed * gamma), -127, 127)
// It is not bit-exact against the plain version, by construction: the sum
// of squares runs in another order than torch's, and rsqrtf is not
// correctly rounded (neither is lax.rsqrt), so normed may differ in its
// last bits and a value on a rounding boundary may take the neighbouring
// code.
//
// Two routes, chosen by static facts (route_of; rmsnorm_quant_route says
// which), never on failure:
//
// "block", the first design, kept for the rows the warp route does not
// take (d not a multiple of 8, d above kMaxWarpD, x not 16-byte aligned).
// One block of 256 threads owns a row: it reads the row into shared memory
// while summing squares, reduces across the block, scales the row in
// shared memory while taking its AbsMax, reduces again and writes the
// codes.  On wide bf16 rows it ran under half its byte bound: 2-byte loads
// and 1-byte stores (64 and 32 bytes a warp instruction), a round trip
// through shared memory for the row and another, after the first
// reduction, for the scale, four barriers in series per row, and at most
// 8 rows an SM, each paying the whole chain of latencies.
//
// "warp", for f32 and bf16 rows with d a multiple of 8 up to kMaxWarpD and
// x 16-byte aligned: the row lives in registers from its loads to its
// stores.  A thread owns chunks of 8 consecutive values (one 16-byte load
// in bf16, two in f32), chunk c going to thread c % (32 R) of the R warps
// that own the row; the chunks a thread holds are a template parameter, so
// every load of the row is issued before any arithmetic.  The scale is
// staged in shared memory once a block while those loads fly, so no
// dependent load waits behind the first reduction.  The sum of squares and
// the AbsMax are each a thread-local pass over its chunks, a
// __shfl_xor_sync tree in each warp and, where R > 1, the warps' results in
// warp order through shared memory behind one barrier.  Codes are clipped,
// converted by one round-to-nearest instruction, packed with __byte_perm
// and stored 8 at a time; the row's first thread writes gamma.  Loads and
// stores carry streaming hints (__ldcs, __stcs: each byte is touched once;
// without them the kernel took 8-10% longer at 8192 rows on an H100).  One
// warp a row (R = 1) was the first form of this route: it keeps a row's
// serial chain of some 1200 instructions on one warp, which left the card
// idle at few rows and, measured at d_model 2048, lost to 2 or 4 warps a
// row at every row count (row_warps has the rule).

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Measurement switch (tools/rmsnorm_variants.py): RQ_SPLIT forces the
// warps a row (1, 2, 4 or 8, with up to 16 chunks a thread) where the rule
// (row_warps) would choose.
#ifndef RQ_SPLIT
#define RQ_SPLIT 0
#endif

namespace {

enum InCode : int { kF32 = 0, kBF16 = 1 };

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

// ---- the "warp" route ----

constexpr int kChunk = 8;            // consecutive values a thread owns together
constexpr int kMaxRowWarps = 8;      // warps a row, at most
constexpr int kMaxLaneChunks = 4;    // chunks a thread holds, at most
constexpr int kMaxWarpD = kMaxLaneChunks * kMaxRowWarps * 32 * kChunk;  // 8192
constexpr int kWideRows = 2048;      // from this many rows a thread holds up to 4 chunks
constexpr int kMinBlockWarps = 4;    // warps a block, at least (a block holds whole rows)

// Warps a row: the fewest (a power of two up to 8) that leave each thread
// at most 2 chunks below kWideRows rows and at most 4 from there up (at
// d_model 2048, 4 warps and 2 warps a row).  Fewer chunks a thread make a
// row's serial chain shorter, which pays while the rows cannot fill the
// card; more make fewer warps meet at barriers once they can.
__host__ __device__ constexpr int row_warps(int m, int d) {
  if (RQ_SPLIT) return RQ_SPLIT;
  const int target = m >= kWideRows ? kMaxLaneChunks : 2, chunks = d / kChunk;
  int r = 1;
  while (r < kMaxRowWarps && (chunks + 32 * r - 1) / (32 * r) > target) r *= 2;
  return r;
}

template <class In>
constexpr int kVecs = (int)sizeof(In) * kChunk / 16;  // 16-byte loads a chunk

// One chunk's 16-byte words as 8 floats (bf16 widens exactly: its bits
// are the top half of the float's).
template <class In>
__device__ __forceinline__ void unpack(const uint4* r, float* v) {
  if constexpr (sizeof(In) == 2) {
    const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[4 * h] = __uint_as_float(r[h].x);
      v[4 * h + 1] = __uint_as_float(r[h].y);
      v[4 * h + 2] = __uint_as_float(r[h].z);
      v[4 * h + 3] = __uint_as_float(r[h].w);
    }
  }
}

// Four codes clip(rint(v * g), -127, 127), lowest address first.  Clipping
// to the integers +-127 before rounding gives the same codes (NaN included:
// fmaxf takes -127 either way), and the round-to-nearest-even conversion
// is one instruction.
__device__ __forceinline__ uint32_t pack4(const float* v, float g) {
  int c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = __float2int_rn(fminf(fmaxf(v[k] * g, -127.0f), 127.0f));
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

// The sum (kind 0) or max (kind 1) over the R warps of a row: a xor tree in
// each warp, then, for R > 1, the warps' results in warp order through
// `red` (this row's R slots) behind a block barrier.
template <int kind, int R>
__device__ __forceinline__ float row_reduce(float v, float* red, int part, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kind == 0 ? v + u : fmaxf(v, u);
  }
  if constexpr (R > 1) {
    if (lane == 0) red[part] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < R; ++w) v = kind == 0 ? v + red[w] : fmaxf(v, red[w]);
  }
  return v;
}

// R warps own a row, and a block holds kBlockWarps / R rows.  Chunk c of a
// row (values 8c .. 8c + 7) goes to thread c % (32 R) of the row's warps as
// its (c / (32 R))-th; a thread holds up to kChunks of them.  The row is in
// registers from its loads to its stores; the scale is staged once a block
// in shared memory while the first loads fly.  Warps past the last row read
// the last row again (so that barriers and shuffles see full warps) and
// store nothing.
template <class In, int kChunks, int R>
__global__ void __launch_bounds__((R > kMinBlockWarps ? R : kMinBlockWarps) * 32)
rmsnorm_quant_warp(const In* __restrict__ x, const float* __restrict__ scale,
                   int8_t* __restrict__ q, float* __restrict__ gamma, int m, int d, float eps) {
  constexpr int kBlockWarps = R > kMinBlockWarps ? R : kMinBlockWarps;
  constexpr int V = kVecs<In>;
  constexpr int kLanes = 32 * R;
  extern __shared__ float4 s_scale[];
  __shared__ float red[2][kBlockWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp % R, t = part * 32 + lane;
  const int chunks = d / kChunk;
  const size_t want = (size_t)blockIdx.x * (kBlockWarps / R) + warp / R;
  const bool live = want < (size_t)m;
  const size_t row = live ? want : (size_t)m - 1;

  auto present = [&](int j) { return t + kLanes * j < chunks; };
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 raw[kChunks * V];
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    if (present(j)) {
#pragma unroll
      for (int w = 0; w < V; ++w) raw[j * V + w] = __ldcs(xr + (t + kLanes * j) * V + w);
    }
  for (int i = threadIdx.x; i < d / 4; i += kBlockWarps * 32)
    s_scale[i] = __ldg(reinterpret_cast<const float4*>(scale) + i);
  __syncthreads();

  float v[kChunks][kChunk];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    if (present(j)) {
      unpack<In>(raw + j * V, v[j]);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) ss = __fmaf_rn(v[j][e], v[j][e], ss);
    }
  float* rred = red[0] + (warp / R) * R;
  ss = row_reduce<0, R>(ss, rred, part, lane);
  const float inv_rms = rsqrtf(ss / (float)d + eps);

  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    if (present(j)) {
      const int c = t + kLanes * j;
      const float4 a = s_scale[2 * c], b = s_scale[2 * c + 1];
      const float s[kChunk] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float cmax[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        v[j][e] = v[j][e] * inv_rms * s[e];
        cmax[e] = fabsf(v[j][e]);
      }
      // max is exact in any order: a tree within the chunk
#pragma unroll
      for (int w = kChunk / 2; w > 0; w >>= 1)
#pragma unroll
        for (int e = 0; e < w; ++e) cmax[e] = fmaxf(cmax[e], cmax[e + w]);
      amax = fmaxf(amax, cmax[0]);
    }
  amax = row_reduce<1, R>(amax, red[1] + (warp / R) * R, part, lane);
  const float g = 127.0f / (amax + 1e-5f);

  if (!live) return;
  uint2* qr = reinterpret_cast<uint2*>(q + row * d);
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    if (present(j))
      __stcs(qr + t + kLanes * j, make_uint2(pack4(v[j], g), pack4(v[j] + 4, g)));
  if (t == 0) gamma[row] = g;
}

template <class In, int kChunks, int R>
cudaError_t launch_warp_n(const void* x, const float* scale, int8_t* q, float* gamma, int m,
                          int d, float eps, cudaStream_t stream) {
  constexpr int kBlockWarps = R > kMinBlockWarps ? R : kMinBlockWarps;
  constexpr int kRows = kBlockWarps / R;
  const size_t smem = (size_t)d * sizeof(float);  // the staged scale
  rmsnorm_quant_warp<In, kChunks, R><<<(m + kRows - 1) / kRows, kBlockWarps * 32, smem, stream>>>(
      static_cast<const In*>(x), scale, q, gamma, m, d, eps);
  return cudaGetLastError();
}

// The chunk count a thread holds: 1-4 (the rule gives no more; forced
// warps a row, RQ_SPLIT, may need up to 16).
template <class In, int R>
cudaError_t launch_warp_r(int per_lane, const void* x, const float* scale, int8_t* q,
                          float* gamma, int m, int d, float eps, cudaStream_t stream) {
  if (per_lane <= 1) return launch_warp_n<In, 1, R>(x, scale, q, gamma, m, d, eps, stream);
  if (per_lane <= 2) return launch_warp_n<In, 2, R>(x, scale, q, gamma, m, d, eps, stream);
  if (per_lane <= 3) return launch_warp_n<In, 3, R>(x, scale, q, gamma, m, d, eps, stream);
  if constexpr (RQ_SPLIT == 0) {
    return launch_warp_n<In, kMaxLaneChunks, R>(x, scale, q, gamma, m, d, eps, stream);
  } else {
    if (per_lane <= 4) return launch_warp_n<In, 4, R>(x, scale, q, gamma, m, d, eps, stream);
    if (per_lane <= 8) return launch_warp_n<In, 8, R>(x, scale, q, gamma, m, d, eps, stream);
    if (per_lane > 16) return cudaErrorInvalidValue;
    return launch_warp_n<In, 16, R>(x, scale, q, gamma, m, d, eps, stream);
  }
}

template <class In>
cudaError_t launch_warp(const void* x, const float* scale, int8_t* q, float* gamma, int m, int d,
                        float eps, cudaStream_t stream) {
  const int r = row_warps(m, d);
  const int per_lane = (d / kChunk + 32 * r - 1) / (32 * r);
  if constexpr (RQ_SPLIT != 0) {
    return launch_warp_r<In, RQ_SPLIT>(per_lane, x, scale, q, gamma, m, d, eps, stream);
  } else {
    switch (r) {
      case 1: return launch_warp_r<In, 1>(per_lane, x, scale, q, gamma, m, d, eps, stream);
      case 2: return launch_warp_r<In, 2>(per_lane, x, scale, q, gamma, m, d, eps, stream);
      case 4: return launch_warp_r<In, 4>(per_lane, x, scale, q, gamma, m, d, eps, stream);
      default: return launch_warp_r<In, 8>(per_lane, x, scale, q, gamma, m, d, eps, stream);
    }
  }
}

// ---- the "block" route (the first design) ----

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
rmsnorm_quant_block(const In* __restrict__ x, const float* __restrict__ scale,
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
cudaError_t launch_block(const void* x, const float* scale, int8_t* q, float* gamma, int m,
                         int d, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_quant_block<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_quant_block<In><<<m, kThreads, smem, stream>>>(static_cast<const In*>(x), scale, q,
                                                          gamma, d, eps);
  return cudaGetLastError();
}

// The route of a launch: the warps a row (1-8) on the "warp" route, 0 on the
// "block" route, -1 for none (bad type or size).
int route_of(int m, int d, int in_dtype, const void* x) {
  if (m < 1 || d < 1 || (in_dtype != kF32 && in_dtype != kBF16)) return -1;
  if (d % kChunk == 0 && d <= kMaxWarpD && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return row_warps(m, d);
  return (size_t)d * sizeof(float) <= kMaxSmem ? 0 : -1;
}

}  // namespace

// The route rmsnorm_quant_launch takes for these arguments: the warps a row
// (1, 2, 4 or 8) on the "warp" route, 0 on the "block" route, -1 none.
extern "C" int rmsnorm_quant_route(int m, int d, int in_dtype, const void* x) {
  return route_of(m, d, in_dtype, x);
}

// Plain C entry point (bound with ctypes): x (m, d) of in_dtype (0 f32,
// 1 bf16), scale (d,) f32 (16-byte aligned on the warp route), q (m, d) i8,
// gamma (m,) f32, all device pointers.  Returns the cudaError_t of the
// launch and never synchronizes.
extern "C" int rmsnorm_quant_launch(const void* x, const float* scale, int8_t* q, float* gamma,
                                    int in_dtype, int m, int d, float eps, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  const int route = route_of(m, d, in_dtype, x);
  if (e == cudaSuccess && (route < 0 || (route > 0 && reinterpret_cast<uintptr_t>(scale) % 16)))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (route > 0)
      e = in_dtype == kF32 ? launch_warp<float>(x, scale, q, gamma, m, d, eps, s)
                           : launch_warp<__nv_bfloat16>(x, scale, q, gamma, m, d, eps, s);
    else
      e = in_dtype == kF32 ? launch_block<float>(x, scale, q, gamma, m, d, eps, s)
                           : launch_block<__nv_bfloat16>(x, scale, q, gamma, m, d, eps, s);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
