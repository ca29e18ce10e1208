// Block-table attention over the paged KV pool for Hopper (sm_90a): the
// attention of every decode step (T = 1) and chunked-prefill slice (T > 1)
// on the serving engine's paged layout.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py
// (pl.pallas_call in paged_attention, _paged_attention_kernel).
//
// Layout: q (B, T, Hq, D); kpool / vpool (NB, BS, Hkv, D); table (B, MB)
// int32 block ids; start (B,) the absolute position of q[:, 0]; kv_lens
// (B,) the resident tokens of each slot.  Query token t of slot b, head
// hq = h * G + g (G = Hq / Hkv), attends the columns j with
// j <= start[b] + t and j < kv_lens[b]; out (B, T, Hq, D) in q's type.
//
// What bounds it on an H100: the bytes of the live K/V pages.  Each query
// row does 4 D flops per resident column against 2 D f32 values of K and
// V (8 D bytes), half a flop per byte at decode and 32 at a 64-row slice
// of one head, against the ~20 flops per byte (67 TFLOP/s f32 over 3.35
// TB/s) at which the cores, not memory, would be the limit.
//
// Design (a simple first kernel; no wgmma, TMA or split-K over the
// context): one block per (slot b, KV head h, tile of 16 query rows),
// where the query rows of one KV head are r = t * G + g, so decode,
// GQA groups and chunk slices are one kernel.  The block walks its slot's
// table one page at a time, up to the last column any of its rows may
// attend (never past kv_lens, so a table entry past the used prefix is
// never read), staging the page's K (rows padded to D + 1 floats, so the
// score loop is free of bank conflicts) and V in shared memory as f32.
// Each warp owns query rows; a lane scores one column of the page (up to
// 32 at a time), and the row keeps its running max, running sum and a D
// wide accumulator (D / 32 values a lane) in f32: the online softmax of
// the Pallas kernel, score = dot(q, k) * scale after the dot, a masked
// column's probability forced to 0 (a fully masked tile leaves m at -1e30,
// where exp(0) = 1 would leak in), expf and IEEE division at the end
// (no fast math).  Column 0 is always valid and page 0 always walked, so
// the sum is positive for every row, the pad rows of a ragged slice too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxSmem = 232448;                 // a block's shared memory on sm_90
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d, int bs) {
  return sizeof(float) * ((size_t)kRowTile * d + (size_t)bs * (d + 1) + (size_t)bs * d);
}

// DL: accumulator values per lane (D <= 32 * DL)
template <int DL, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                       const TKV* __restrict__ vpool, const int* __restrict__ table,
                       const int* __restrict__ start, const int* __restrict__ kv_lens,
                       TQ* __restrict__ out, int t, int hq, int hkv, int d, int bs, int mb,
                       float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRowTile][d]
  float* ks = qs + kRowTile * d;     // [bs][d + 1]
  float* vs = ks + bs * (d + 1);     // [bs][d]

  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  const int row0 = blockIdx.z * kRowTile;
  const int nrows = min(kRowTile, t * g - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int st = start[b];
  const int len = max(kv_lens[b], 1);

  for (int i = tid; i < nrows * d; i += kThreads) {
    const int rl = i / d, dd = i - rl * d;
    const int r = row0 + rl, tt = r / g, gg = r - tt * g;
    qs[i] = to_f32(q[(((size_t)b * t + tt) * hq + (size_t)h * g + gg) * d + dd]);
  }

  // the last column any row of this tile attends bounds the page walk
  const int last_col = min(st + (row0 + nrows - 1) / g, len - 1);
  const int pages = min(last_col / bs + 1, mb);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[j][i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * d;
  for (int p = 0; p < pages; ++p) {
    const size_t base = (size_t)table[(size_t)b * mb + p] * bs * row_stride + (size_t)h * d;
    __syncthreads();  // the previous page's readers are done
    for (int i = tid; i < bs * d; i += kThreads) {
      const int s = i / d, dd = i - s * d;
      const size_t off = base + (size_t)s * row_stride + dd;
      ks[s * (d + 1) + dd] = to_f32(kpool[off]);
      vs[i] = to_f32(vpool[off]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int rl = j * kWarps + warp;  // warp-uniform
      if (rl < nrows) {
        const int lim = min(st + (row0 + rl) / g, len - 1);  // last column it attends
        const float* qr = qs + rl * d;
        for (int c0 = 0; c0 < bs; c0 += 32) {
          const int c = c0 + lane;
          const bool valid = c < bs && p * bs + c <= lim;
          float s = kNegInf;
          if (valid) {
            const float* kr = ks + c * (d + 1);
            float dot = 0.f;
            for (int dd = 0; dd < d; ++dd) dot += qr[dd] * kr[dd];
            s = dot * scale;
          }
          const float m_new = fmaxf(m[j], warp_max(s));
          const float pc = valid ? expf(s - m_new) : 0.f;
          const float alpha = expf(m[j] - m_new);
          l[j] = l[j] * alpha + warp_sum(pc);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[j][i] *= alpha;
          const int ncol = min(32, bs - c0);
          for (int cc = 0; cc < ncol; ++cc) {
            const float w = __shfl_sync(0xffffffffu, pc, cc);
            const float* vr = vs + (c0 + cc) * d;
#pragma unroll
            for (int i = 0; i < DL; ++i) {
              const int dd = lane + 32 * i;
              if (dd < d) acc[j][i] += w * vr[dd];
            }
          }
          m[j] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int rl = j * kWarps + warp;
    if (rl < nrows) {
      const int r = row0 + rl, tt = r / g, gg = r - tt * g;
      TQ* o = out + (((size_t)b * t + tt) * hq + (size_t)h * g + gg) * d;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < d) store(o + dd, acc[j][i] / l[j]);
      }
    }
  }
}

template <int DL, typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kpool, const void* vpool, const int* table,
                   const int* start, const int* kv_lens, void* out, int b, int t, int hq,
                   int hkv, int d, int bs, int mb, float scale, cudaStream_t stream) {
  auto kern = paged_attention_kernel<DL, TQ, TKV>;
  const size_t smem = smem_bytes(d, bs);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(b, hkv, (t * (hq / hkv) + kRowTile - 1) / kRowTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kpool), static_cast<const TKV*>(vpool),
      table, start, kv_lens, static_cast<TQ*>(out), t, hq, hkv, d, bs, mb, scale);
  return cudaGetLastError();
}

template <int DL>
cudaError_t dispatch_types(int q_code, int kv_code, const void* q, const void* kpool,
                           const void* vpool, const int* table, const int* start,
                           const int* kv_lens, void* out, int b, int t, int hq, int hkv, int d,
                           int bs, int mb, float scale, cudaStream_t s) {
  if (q_code == 0 && kv_code == 0)
    return launch<DL, float, float>(q, kpool, vpool, table, start, kv_lens, out, b, t, hq, hkv,
                                    d, bs, mb, scale, s);
  if (q_code == 0 && kv_code == 1)
    return launch<DL, float, __nv_bfloat16>(q, kpool, vpool, table, start, kv_lens, out, b, t,
                                            hq, hkv, d, bs, mb, scale, s);
  if (q_code == 1 && kv_code == 0)
    return launch<DL, __nv_bfloat16, float>(q, kpool, vpool, table, start, kv_lens, out, b, t,
                                            hq, hkv, d, bs, mb, scale, s);
  if (q_code == 1 && kv_code == 1)
    return launch<DL, __nv_bfloat16, __nv_bfloat16>(q, kpool, vpool, table, start, kv_lens, out,
                                                    b, t, hq, hkv, d, bs, mb, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes): q (b, t, hq, d), kpool / vpool
// (nb, bs, hkv, d), out (b, t, hq, d) like q; table (b, mb), start (b,),
// kv_lens (b,) int32; all device pointers.  q_code / kv_code: 0 float32,
// 1 bfloat16.  Needs hq % hkv == 0 and d <= 256.  Returns the cudaError_t
// of the launch and never synchronizes.
extern "C" int paged_attention_launch(const void* q, const void* kpool, const void* vpool,
                                      const int* table, const int* start, const int* kv_lens,
                                      void* out, int q_code, int kv_code, int b, int t, int hq,
                                      int hkv, int d, int bs, int mb, float scale, int device,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (b < 1 || t < 1 || hkv < 1 || hq % hkv || d < 1 || d > 256 ||
                           bs < 1 || mb < 1 || smem_bytes(d, bs) > (size_t)kMaxSmem))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    cudaStream_t s = (cudaStream_t)stream;
    if (d <= 32)
      e = dispatch_types<1>(q_code, kv_code, q, kpool, vpool, table, start, kv_lens, out, b, t,
                            hq, hkv, d, bs, mb, scale, s);
    else if (d <= 64)
      e = dispatch_types<2>(q_code, kv_code, q, kpool, vpool, table, start, kv_lens, out, b, t,
                            hq, hkv, d, bs, mb, scale, s);
    else if (d <= 128)
      e = dispatch_types<4>(q_code, kv_code, q, kpool, vpool, table, start, kv_lens, out, b, t,
                            hq, hkv, d, bs, mb, scale, s);
    else
      e = dispatch_types<8>(q_code, kv_code, q, kpool, vpool, table, start, kv_lens, out, b, t,
                            hq, hkv, d, bs, mb, scale, s);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
