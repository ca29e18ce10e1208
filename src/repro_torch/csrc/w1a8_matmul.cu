// Prefill-tier W1A8 GEMM for Hopper (sm_90a): the packed 1-bit linears
// (q/k/v/o and the FFN's w1_down) above the decode tier's 32 rows, on
// activations already quantized per token:
// y = float(x_i8 @ unpack(wp)) * (lam * (1 / gamma)), x (M, K) int8
// row-major, wp (K/8, N) packed signs, gamma (M,) f32, lam one f32, y (M,
// N) f32 or bf16.
//
// Replaces the Pallas kernel src/repro/kernels/w1a8_matmul.py (pl.pallas_call
// in w1a8_matmul, _w1a8_kernel).
//
// What bounds it on an H100: at prefill (M = 8192 rows of a 128-token batch
// of 64) the int8 operations, 2 M K N, over the card's 1979 int8 TOP/s:
// 34.7 us at K 2048 and 85.2 us at K 5024 (N 2048); the bytes (x once,
// the packed weight once, the f32 output once) take 25 us.  Only wgmma
// reaches that rate; mma.sync tops out near a fifth of it.
//
// Two routes behind the one entry point, chosen by shape (never on
// failure; w1a8_matmul_route says which):
//
//   * "wgmma" (K and N multiples of 16, as the TMA descriptors need): a
//     warp-specialised persistent kernel on the pieces of wgmma_pipe.cuh.
//     It multiplies Y^T = W^T X^T, so that the activation tile is wgmma's
//     shared-memory operand B in the layout it has in device memory and
//     the weight is operand A, expanded from its packed bits straight into
//     registers (three integer instructions a word; no expanded weight in
//     shared memory, no proxy fence).  Warpgroup 0 is the producer: one
//     thread keeps a ring of kStages stages in flight, each a 128-row x
//     128-byte activation box (TMA, 128-byte swizzle, zero past M and K,
//     so the ragged K tail is read as zeros) and the matching 16 x BN
//     packed box, behind one "full" and one "empty" mbarrier a stage.
//     Warpgroups 1 and 2 are the consumers: each owns BN/2 weight columns
//     (kSlices m64 slices) of the block's tile of 128 activation rows x BN
//     columns, loads its packed bits of a stage with 16-bit shared loads,
//     and per k32 step expands the next step's fragments while the last
//     step's wgmma.m64n128k32 run (one wgmma group in flight, no block-wide
//     barrier anywhere in the K loop).  A block walks every gridDim.x-th
//     tile (columns fastest, so the blocks in flight share their
//     activation rows in L2); the producer runs ahead into the next tile
//     while the consumers store the last one.  BN is 256 (kSlices 2,
//     int32 accumulators in 128 registers a thread under setmaxnreg) when
//     those tiles fill the card, else 128.
//     Two ways to hide the stores were built and measured slower on an
//     H100 (PERF.md): the second consumer started a few stages behind the
//     first, so that one's stores would run beside the other's MMAs (11-13%
//     slower at every M, the skew's bookkeeping in the K loop costing more
//     than the overlap gains), and the scaled tile staged in shared memory
//     for TMA bulk stores (85 against 65 us at K 2048: the staging leaves
//     room for 4 stages, and the 256-column kernels spill).
//   * "mma" (any other shape: N not a multiple of 16): the first design's
//     tile of tile_gemm.cuh, one block an output tile, mma.sync m16n8k32
//     on int8, 64-byte K stages, the signs expanded per stage into a
//     [n][k] tile.
//
// The epilogue of both routes keeps the Pallas kernel's order of
// operations, float(acc) * (lam * (1 / gamma)), with IEEE division (no
// fast math), reads gamma once per row of a tile, only for rows < M, and
// writes out_dtype (f32, or bf16 rounded to nearest even), so the output
// equals the plain version bit for bit.

#include "tile_gemm.cuh"
#include "wgmma_pipe.cuh"

using namespace repro_tile;
namespace sm90 = repro_sm90;

namespace {

// ---- the "mma" route: tile_gemm.cuh's tile ----

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
cudaError_t launch_mma(const int8_t* x, const uint8_t* wp, const float* gamma, const float* lam,
                       Out* out, int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w1a8_matmul_kernel<BM, BN, Out><<<grid, kThreads, 0, stream>>>(x, wp, gamma, lam, out, m, k, n);
  return cudaGetLastError();
}

// ---- the "wgmma" route ----

constexpr int kBM = 128;       // activation rows a tile: the wgmma's N
constexpr int kBK = 128;       // K bytes a stage: one swizzled row, four k32 steps
constexpr int kStages = 8;     // ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWgThreads = 128 * (1 + kConsumers);

template <int kSlices>  // m64 slices of weight columns a consumer owns
struct WTile {
  static constexpr int kBN = 64 * kSlices * kConsumers;  // weight columns a tile
  static constexpr int kXBytes = kBM * kBK;              // activation box a stage
  static constexpr int kWBytes = kBK / 8 * kBN;          // packed box a stage
  // dynamic shared memory, from a 1024-byte-aligned base: the activation
  // stages, the packed stages, two row-scale buffers per consumer, the
  // barriers
  static constexpr int kWOff = kStages * kXBytes;
  static constexpr int kScaleOff = kWOff + kStages * kWBytes;
  static constexpr int kBarOff = kScaleOff + kConsumers * 2 * kBM * (int)sizeof(float);
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + the base's alignment
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int kSlices, class Out>
__global__ void __launch_bounds__(kWgThreads, 1)
w1a8_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ gamma,
                  const float* __restrict__ lam_p, Out* __restrict__ out, int m, int k, int n) {
  using T = WTile<kSlices>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  const unsigned char* ws = smem + T::kWOff;
  float* scales = reinterpret_cast<float*>(smem + T::kScaleOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kStages;

  const int col_tiles = (n + T::kBN - 1) / T::kBN;
  const int tiles = (m + kBM - 1) / kBM * col_tiles, nk = (k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers * 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every copy
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
        const int row0 = tile / col_tiles * kBM, col0 = tile % col_tiles * T::kBN;
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round finds every stage free
          sm90::mbar_expect_tx(&full[stage], T::kXBytes + T::kWBytes);
          sm90::tma_load_2d(xs + stage * T::kXBytes, &tmap_x, &full[stage], kt * kBK, row0);
          sm90::tma_load_2d(smem + T::kWOff + stage * T::kWBytes, &tmap_w, &full[stage], col0,
                            kt * (kBK / 8));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // the consumer warpgroups
    sm90::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    // this lane's two weight columns (2 g, 2 g + 1 of its warp's 16) of
    // slice 0, as a byte offset into a packed row of the tile; the packed
    // rows it reads are (t >> 1) + 2 j, the nibble 4 (t & 1)
    const int wcol = cw * 64 * kSlices + 16 * warp + 2 * g;
    const int kb_lane = t >> 1, shift = 4 * (t & 1);
    const float lam = *lam_p;

    int acc[kSlices][64];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0;

    int stage = 0, last = 0, round = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x, ++round) {
      const int row0 = tile / col_tiles * kBM, col0 = tile % col_tiles * T::kBN;
      const int rows = min(kBM, m - row0);
      // the row's scale, loaded under the MMAs (once per row, rows < M only)
      const float gv = tid < rows ? gamma[row0 + tid] : 1.0f;
      for (int kt = 0; kt < nk; ++kt) {
        sm90::mbar_wait(&full[stage], phase);
        const unsigned char* wst = ws + stage * T::kWBytes;
        uint32_t v[kSlices][8];  // packed row kb_lane + 2 j, both columns, every slice
#pragma unroll
        for (int i = 0; i < kSlices; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[i][j] = *reinterpret_cast<const uint16_t*>(wst + (kb_lane + 2 * j) * T::kBN +
                                                         wcol + 64 * i);
        const uint64_t desc = sm90::desc_sw128(sm90::smem_addr(xs + stage * T::kXBytes));
#pragma unroll
        for (int s = 0; s < kBK / 32; ++s) {
          uint32_t a[kSlices][4];
#pragma unroll
          for (int i = 0; i < kSlices; ++i)
            sm90::sign_fragment(v[i][2 * s], v[i][2 * s + 1], shift, a[i]);
          sm90::wgmma_fence();
#pragma unroll
          for (int i = 0; i < kSlices; ++i)
            sm90::wgmma_m64n128k32_s8(acc[i], a[i], desc + 2 * s, kt > 0 || s > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous k32 step is done
          // the previous stage's last step was: its buffers may refill
          if (s == 0 && kt > 0) sm90::mbar_arrive(&empty[last]);
        }
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[last]);

      // epilogue: this warpgroup's scales of the tile's rows (two buffers,
      // so the next tile's writes cannot meet this tile's reads), then the
      // accumulators straight to device memory, two adjacent columns a store
      float* sc = scales + (cw * 2 + (round & 1)) * kBM;
      sc[tid] = lam * (1.0f / gv);
      sm90::named_bar_sync(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < kSlices; ++i) {
        const int col = col0 + wcol + 64 * i;
        if (col >= n) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * t + e;
            if (r < rows) {
              const float s = sc[r];
              store2(out + (size_t)(row0 + r) * n + col, (float)acc[i][4 * j + e] * s,
                     (float)acc[i][4 * j + 2 + e] * s);
            }
          }
      }
    }
  }
}

template <int kSlices, class Out>
cudaError_t launch_wgmma(const int8_t* x, const uint8_t* wp, const float* gamma,
                         const float* lam, Out* out, int m, int k, int n, int sms,
                         int device, cudaStream_t s) {
  using T = WTile<kSlices>;
  static std::atomic<bool> smem_allowed[sm90::kMaxDevices];
  CUtensorMap tmap_x, tmap_w;
  cudaError_t e = sm90::encode_2d(&tmap_x, x, k, m, k, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = sm90::encode_2d(&tmap_w, wp, n, k / 8, n, T::kBN, kBK / 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  const auto kernel = w1a8_wgmma_kernel<kSlices, Out>;
  if (e == cudaSuccess) e = sm90::allow_smem(kernel, T::kSmem, device, smem_allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kBM - 1) / kBM * ((n + T::kBN - 1) / T::kBN);
  kernel<<<min(tiles, sms), kWgThreads, T::kSmem, s>>>(tmap_x, tmap_w, gamma, lam, out, m, k, n);
  return cudaGetLastError();
}

// The route of a shape: wgmma needs K and N multiples of 16 (the byte
// strides of the TMA boxes).
inline bool wgmma_route(int m, int k, int n) { return k % 16 == 0 && n % 16 == 0; }

template <class Out>
cudaError_t launch(const int8_t* x, const uint8_t* wp, const float* gamma, const float* lam,
                   void* out_v, int m, int k, int n, int device, cudaStream_t s) {
  Out* out = static_cast<Out*>(out_v);
  if (wgmma_route(m, k, n)) {
    int sms = 0;
    const cudaError_t e = sm90::sm_count(device, &sms);
    if (e != cudaSuccess) return e;
    // 256-column tiles once they fill the card, else 128 (twice the blocks)
    const bool wide = (long)((m + kBM - 1) / kBM) * ((n + 255) / 256) >= sms;
    return wide ? launch_wgmma<2, Out>(x, wp, gamma, lam, out, m, k, n, sms, device, s)
                : launch_wgmma<1, Out>(x, wp, gamma, lam, out, m, k, n, sms, device, s);
  }
  return big_tiles(m, n, device) ? launch_mma<128, 128, Out>(x, wp, gamma, lam, out, m, k, n, s)
                                 : launch_mma<64, 64, Out>(x, wp, gamma, lam, out, m, k, n, s);
}

}  // namespace

// The route w1a8_matmul_launch takes for (m, k, n): 1 wgmma, 0 mma.
extern "C" int w1a8_matmul_route(int m, int k, int n) { return wgmma_route(m, k, n) ? 1 : 0; }

// Plain C entry point (bound with ctypes): x (m, k) i8, wp (k/8, n) u8,
// gamma (m,) f32, lam one f32, out (m, n) of out_dtype (0 f32, 1 bf16),
// all device pointers; k a multiple of 16, x 16-byte aligned (and wp too
// on the wgmma route).  Returns the cudaError_t of the launch and never
// synchronizes.
extern "C" int w1a8_matmul_launch(const int8_t* x, const uint8_t* wp, const float* gamma,
                                  const float* lam, void* out, int out_dtype, int m, int k, int n,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (m < 1 || n < 1 || k < 16 || k % 16)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (out_dtype) {
      case kF32: e = launch<float>(x, wp, gamma, lam, out, m, k, n, device, s); break;
      case kBF16: e = launch<__nv_bfloat16>(x, wp, gamma, lam, out, m, k, n, device, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
