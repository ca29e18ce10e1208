// W8A8 matmul for Hopper (sm_90a): the decoupled FFN's 8-bit down
// projection (w8_down), on activations already quantized per token:
// y = float(x_i8 @ w_i8) * (1 / (gamma * wscale)), x (M, K) and w (K, N)
// int8 row-major, gamma (M,) f32, wscale one f32, y (M, N) f32 or bf16.
//
// Replaces the Pallas kernel src/repro/kernels/int8_matmul.py (pl.pallas_call
// in int8_matmul, _int8_kernel).
//
// What bounds it on an H100 (3.35 TB/s, 1979 int8 TOP/s) at w8_down's K
// 384, N 2048: the bytes at every M, and above a few dozen rows the output
// write among them.  M 33: 1.07 MB, 0.319 us; M 512: 5.18 MB, 1.546 us;
// M 1024: 9.57 MB, 2.857 us; M 8192: 71.1 MB (67.1 MB of it the f32
// output), 21.216 us in f32 and 11.200 us in bf16, against 12.9 G integer
// operations, 6.5 us.
//
// Two routes behind the one entry point, chosen by shape (never on failure):
//
//   * M <= 32 rows, or K not a multiple of 16 or above kKMax = 1024, or N
//     not a multiple of 4: the GEMV block of gemv_common.cuh, which at the
//     decode shapes reads the 768 KB weight once per 32 rows.  Each block
//     copies up to 32 int8 token rows (blockIdx.y picks the row tile, so
//     any M runs) into shared memory and owns 8 output columns, four lanes
//     to a column; a lane gathers four int8 weights of its column down K
//     into one word and feeds one __dp4a per token row.
//   * every other shape: the tensor-core tile below.
//
// The tile.  A block owns BN output columns and walks every gridDim.y-th
// row tile of BM rows (BM x BN = 128 x 128 when those tiles fill the
// card's 132 SMs and K <= 384, else 64 x 64; 8 warps in a 2 x 4 grid;
// gridDim.y = as many row groups as the card holds blocks beside the
// column tiles).  All of K stays in shared memory: the block's weight
// columns, transposed into [n][k] once (four words down K become four
// words along K in registers: ldmatrix moves 16-bit elements, so it
// cannot transpose int8), and one activation tile, loaded by cp.async (16
// bytes a thread, zero past M and K).  A row tile is one wait, one barrier
// and every k32 step with no barrier between them: ldmatrix.x4 feeds
// mma.sync.m16n8k32.s8 (one x4 for an A 16 x 32 fragment, one for two B
// 8 x 32 fragments: 6 loads for 16 MMAs per warp and step).  Shared rows
// are 128-byte multiples, the 16-byte chunk c of row r stored at
// c ^ ((r & 7) ^ ((r >> 3) & 3)): the ldmatrix phases (8 rows, one chunk),
// the cp.async stores (8 chunks of a row) and the transposing stores (4 K
// words of one chunk x 8 column groups 4 apart) each hit 32 distinct banks.
// After the MMAs the next row tile's cp.async starts, and the scaled sums
// go from the fragments straight to device memory (8-byte f32 or 4-byte
// bf16 pairs, whole 32-byte sectors) while the SM's other block
// multiplies: at 128 x 128 a block holds 96.5 KB, so two share an SM.
// A staged epilogue (the tile scaled into shared memory, then one
// cp.async.bulk per row) was built and measured slower on an H100 at 8192
// rows, 45.5 against 37.3 us (PERF.md): its 68 KB staging tile
// leaves room for one block an SM, and nothing then overlaps the staging
// and the wait for the copies to read it.
//
// Why not wgmma: the integer work is under a third of the bound at 8192
// rows, so mma.sync has to keep ahead of the output write, not reach the
// tensor cores' peak; int8 wgmma would need both operands K-major in its
// canonical swizzled layout behind 64-bit matrix descriptors.
//
// The epilogue of both routes keeps the Pallas kernel's order of
// operations, float(acc) * (1 / (gamma * wscale)), with IEEE division (no
// fast math), reads gamma once per row of a tile, only for rows < M, and
// writes out_dtype (f32, or bf16 rounded to nearest even), so the output
// equals the plain version bit for bit.

#include "gemv_common.cuh"
#include "tile_gemm.cuh"

using namespace repro;
namespace rt = repro_tile;

namespace {

constexpr int kRowTile = 32;  // token rows per GEMV block (blockIdx.y)

template <class Out>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ gamma, const float* __restrict__ wscale_p,
                 Out* __restrict__ out, int m, int k, int n) {
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
      rt::store_out(out + (size_t)(base + row) * n + col, (float)sum * inv);
    }
  }
}

// ---- the tensor-core tile ----

constexpr int kKMax = 1024;  // K bytes the tile keeps resident (64 x 64; 384 at 128 x 128)

template <int BM, int BN>
struct Tile {
  static constexpr int kWM = BM / 2, kWN = BN / 4;    // warp tile (2 x 4 warps)
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;  // m16n8 MMA tiles per warp
  static constexpr int kBBatch = BN * 384 / 16 / rt::kThreads;  // 4 x 4 weight blocks in flight
  static_assert(kMT >= 1 && kNT % 2 == 0, "ldmatrix.x4 feeds B two n8 tiles at a time");
};

// Byte offsets of a block's dynamic shared memory for K = k: the weight
// ([n][k], BN rows) and one activation tile (BM rows), rows of kp bytes;
// the row scales.
template <int BM, int BN>
struct Plan {
  int kp, a_off, inv_off, total;
  __host__ __device__ explicit Plan(int k) {
    kp = (k + 127) / 128 * 128;
    a_off = BN * kp;
    inv_off = a_off + BM * kp;
    total = inv_off + BM * (int)sizeof(float);
  }
};

// Chunk swizzle of shared row r (see the source note).
__device__ __forceinline__ int swz(int r) { return (r & 7) ^ ((r >> 3) & 3); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const int8_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(s));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Activation rows [row0, row0 + BM) x K bytes [0, kq) into `sa` (swizzled
// rows of kp bytes) by cp.async, zero-filled past M and K.
template <int BM>
__device__ __forceinline__ void load_a(int8_t* sa, int kp, const int8_t* __restrict__ x, int m,
                                       int k, int row0, int kq) {
  const int cpr = kq / 16;  // 16-byte chunks a row
  const int dr = rt::kThreads / cpr, dc = rt::kThreads - dr * cpr;
  for (int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr; r < BM;
       r += dr + (c + dc >= cpr), c += dc - (c + dc >= cpr ? cpr : 0)) {
    const int row = row0 + r, kk = 16 * c;
    const bool ok = row < m && kk < k;
    // a zero-byte copy still needs a valid address: point it at x itself
    rt::cp_async16(sa + r * kp + ((c ^ swz(r)) << 4), ok ? x + (size_t)row * k + kk : x,
                   ok ? 16 : 0);
  }
  rt::cp_async_commit();
}

// Weight columns [col0, col0 + BN) x K rows [0, kq) of w (k x n, row-major,
// n a multiple of 4), transposed into `sb` ([n][k], swizzled rows of kp
// bytes), zero past N and K, in the 4 x 4 byte blocks of tile_gemm.cuh's
// Int8B (a warp takes 8 column groups x one 16-byte K chunk: each load
// reads 32 contiguous bytes of 4 rows, and under swz each store hits 32
// distinct banks).  Each batch issues all of its loads before its first
// store (one batch covers K 384).
template <int BN>
__device__ __forceinline__ void load_b(int8_t* sb, int kp, const int8_t* __restrict__ w, int n,
                                       int k, int col0, int kq) {
  constexpr int kB = Tile<32, BN>::kBBatch;
  const int blocks = BN / 4 * (kq / 4);
  for (int base = threadIdx.x; base < blocks; base += kB * rt::kThreads) {
    uint32_t v[kB][4];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int idx = base + j * rt::kThreads;
      int cg, kg;
      rt::Int8B<BN>::block_of(idx, cg, kg);
      const int col = col0 + 4 * cg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = 4 * kg + i;
        v[j][i] = idx < blocks && col < n && kk < k
                      ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)kk * n + col))
                      : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int idx = base + j * rt::kThreads;
      if (idx < blocks) {
        int cg, kg;
        rt::Int8B<BN>::block_of(idx, cg, kg);
        uint32_t t[4];
        rt::transpose4x4(v[j], t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * cg + i;
          *reinterpret_cast<uint32_t*>(sb + r * kp + (((kg >> 2) ^ swz(r)) << 4) +
                                       4 * (kg & 3)) = t[i];
        }
      }
    }
  }
}

template <int BM, int BN>
using Acc = int[Tile<BM, BN>::kMT][Tile<BM, BN>::kNT][4];

// acc = A tile x B over `steps` k32 steps, fragments by ldmatrix.x4.
template <int BM, int BN>
__device__ __forceinline__ void mma_tile(const int8_t* sa, const int8_t* sb, int kp, int steps,
                                         Acc<BM, BN>& acc) {
  using T = Tile<BM, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / 4, wn = warp % 4;
  // lane l addresses row (l & 7) of matrix l / 8: A matrices (rows 0-7 |
  // 8-15) x (K bytes 0-15 | 16-31), B matrices (K 0-15 | 16-31) x (n 0-7 | 8-15)
  const int8_t* pa[T::kMT];
  int ga[T::kMT];
#pragma unroll
  for (int mi = 0; mi < T::kMT; ++mi) {
    const int r = wm * T::kWM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    pa[mi] = sa + r * kp;
    ga[mi] = swz(r) ^ (lane >> 4);
  }
  const int8_t* pb[T::kNT / 2];
  int gb[T::kNT / 2];
#pragma unroll
  for (int nj = 0; nj < T::kNT / 2; ++nj) {
    const int r = wn * T::kWN + nj * 16 + (lane & 7) + (lane >> 4) * 8;
    pb[nj] = sb + r * kp;
    gb[nj] = swz(r) ^ ((lane >> 3) & 1);
  }
#pragma unroll
  for (int mi = 0; mi < T::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    uint32_t a[T::kMT][4], b[T::kNT][2];
#pragma unroll
    for (int mi = 0; mi < T::kMT; ++mi) ldsm_x4(a[mi], pa[mi] + (((2 * s) ^ ga[mi]) << 4));
#pragma unroll
    for (int nj = 0; nj < T::kNT / 2; ++nj) {
      uint32_t d[4];
      ldsm_x4(d, pb[nj] + (((2 * s) ^ gb[nj]) << 4));
      b[2 * nj][0] = d[0];
      b[2 * nj][1] = d[1];
      b[2 * nj + 1][0] = d[2];
      b[2 * nj + 1][1] = d[3];
    }
#pragma unroll
    for (int mi = 0; mi < T::kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::kNT; ++ni) rt::mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

template <int BM, int BN, class Out>
__global__ void __launch_bounds__(rt::kThreads, 2)
int8_tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ gamma, const float* __restrict__ wscale_p,
                 Out* __restrict__ out, int m, int k, int n) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];  // the same declaration as the GEMV's
  const Plan<BM, BN> p(k);
  int8_t* sb = reinterpret_cast<int8_t*>(smem);
  int8_t* sa = sb + p.a_off;
  float* inv = reinterpret_cast<float*>(smem + p.inv_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * BN, cols = min(BN, n - col0);
  const int tiles = (m + BM - 1) / BM, kq = (k + 31) / 32 * 32;
  const float wscale = *wscale_p;

  int tile = blockIdx.y;
  load_a<BM>(sa, p.kp, x, m, k, tile * BM, kq);
  load_b<BN>(sb, p.kp, w, n, k, col0, kq);
  for (; tile < tiles; tile += (int)gridDim.y) {
    const int row0 = tile * BM, rows = min(BM, m - row0);
    // the row's scale, loaded under the MMAs (once per row, rows < M only)
    const float gv = tid < rows ? gamma[row0 + tid] : 1.0f;
    rt::cp_async_wait_all();
    __syncthreads();  // the tile's rows (and the weight) are in; the last scales are read

    Acc<BM, BN> acc;
    mma_tile<BM, BN>(sa, sb, p.kp, kq / 32, acc);
    if (tid < BM) inv[tid] = 1.0f / (gv * wscale);
    __syncthreads();  // every warp is done with the rows; the scales are in

    // the next row tile's copy runs under this tile's epilogue, and the
    // other block on the SM multiplies while this one stores
    const int next = tile + (int)gridDim.y;
    if (next < tiles) load_a<BM>(sa, p.kp, x, m, k, next * BM, kq);
#pragma unroll
    for (int mi = 0; mi < T::kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::kWM + mi * 16 + g + 8 * h;
        if (r >= rows) continue;
        const float s = inv[r];
        Out* orow = out + (size_t)(row0 + r) * n + col0;
#pragma unroll
        for (int ni = 0; ni < T::kNT; ++ni) {
          const int c = wn * T::kWN + ni * 8 + 2 * t;
          if (c < cols)
            store2(orow + c, (float)acc[mi][ni][2 * h] * s, (float)acc[mi][ni][2 * h + 1] * s);
        }
      }
  }
}

template <class Out>
cudaError_t launch_gemv(const int8_t* x, const int8_t* w, const float* gamma,
                        const float* wscale, Out* out, int m, int k, int n, cudaStream_t s) {
  const SmemPlan p = smem_plan(m < kRowTile ? m : kRowTile, k);
  if (p.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(int8_gemv_kernel<Out>, p.total);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kInt8Cols - 1) / kInt8Cols, (m + kRowTile - 1) / kRowTile);
  int8_gemv_kernel<Out><<<grid, kThreads, p.total, s>>>(x, w, gamma, wscale, out, m, k, n);
  return cudaGetLastError();
}

// One block per BN columns and row group: as many row groups as the
// card holds blocks beside the column tiles, each walking every
// gridDim.y-th row tile.
template <int BM, int BN, class Out>
cudaError_t launch_tile(const int8_t* x, const int8_t* w, const float* gamma,
                        const float* wscale, Out* out, int m, int k, int n, int device,
                        cudaStream_t s) {
  const Plan<BM, BN> p(k);
  const auto kernel = int8_tile_kernel<BM, BN, Out>;
  cudaError_t e = allow_smem(kernel, p.total);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, rt::kThreads, p.total);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int col_tiles = (n + BN - 1) / BN, row_tiles = (m + BM - 1) / BM;
  const int groups = max(1, min(row_tiles, per_sm * sms / col_tiles));
  kernel<<<dim3(col_tiles, groups), rt::kThreads, p.total, s>>>(x, w, gamma, wscale, out, m, k,
                                                                n);
  return cudaGetLastError();
}

// The route of a shape: the tile needs more than the decode tier's rows,
// 16-byte activation rows (cp.async), K resident (kKMax) and 4-byte
// weight words.
inline bool tile_route(int m, int k, int n) {
  return m > 32 && k % 16 == 0 && k <= kKMax && n % 4 == 0;
}

template <class Out>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* gamma, const float* wscale,
                   void* out_v, int m, int k, int n, int device, cudaStream_t s) {
  Out* out = static_cast<Out*>(out_v);
  if (!tile_route(m, k, n)) return launch_gemv<Out>(x, w, gamma, wscale, out, m, k, n, s);
  return k <= 384 && rt::big_tiles(m, n, device)
             ? launch_tile<128, 128, Out>(x, w, gamma, wscale, out, m, k, n, device, s)
             : launch_tile<64, 64, Out>(x, w, gamma, wscale, out, m, k, n, device, s);
}

}  // namespace

// The route int8_matmul_launch takes for (m, k, n): 1 the tensor-core
// tile, 0 the GEMV.
extern "C" int int8_matmul_route(int m, int k, int n) { return tile_route(m, k, n) ? 1 : 0; }

// Plain C entry point (bound with ctypes): x (m, k) i8, w (k, n) i8,
// gamma (m,) f32, wscale one f32, out (m, n) of out_dtype (0 f32, 1 bf16),
// all device pointers; k a multiple of 4.  The tile route needs x 16-byte
// and w 4-byte aligned; the GEMV reads bytes and needs neither.
// Returns the cudaError_t of the launch and never synchronizes.
extern "C" int int8_matmul_launch(const int8_t* x, const int8_t* w, const float* gamma,
                                  const float* wscale, void* out, int out_dtype, int m, int k,
                                  int n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (m < 1 || n < 1 || k < 4 || k % 4)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (out_dtype) {
      case rt::kF32: e = launch<float>(x, w, gamma, wscale, out, m, k, n, device, s); break;
      case rt::kBF16: e = launch<__nv_bfloat16>(x, w, gamma, wscale, out, m, k, n, device, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
