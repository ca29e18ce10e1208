// Prefill-tier fused first GEMM of the decoupled FFN for Hopper (sm_90a):
// both up-projections of one FFN input (the 1-bit trunk and the r-wide
// 8-bit branch) in one launch, on activations already quantized per token.
//
// Replaces the Pallas kernel src/repro/kernels/decoupled_matmul.py
// (pl.pallas_call in decoupled_matmul, _decoupled_kernel).
//
// What bounds it on an H100: at prefill (M = 8192 rows) the int8
// operations, 2 M K (N + r), over the card's 1979 int8 TOP/s: 91.7 us at
// pquant-1.3b's K 2048, N 5024, r 384.  Only wgmma reaches that rate.
//
// The TPU kernel walks the trunk's N tiles and pins the whole 8-bit weight
// (r <= bn) beside them, accumulating it on the j == 0 pass only, so its
// sequential grid reads each activation tile once for both branches.
// Blocks on Hopper run in no order, so here one launch holds the tiles of
// both branches instead.  Two routes behind the one entry point, chosen by
// shape (never on failure; decoupled_matmul_route says which):
//
//   * "wgmma" (K, N and r multiples of 16: the row strides of x, the
//     packed signs and w8 as TMA needs them): a warp-specialised
//     persistent kernel on the pieces of wgmma_pipe.cuh, as w1a8_matmul's.
//     It multiplies Y^T = W^T X^T: the activation box (128 rows x 128 K
//     bytes, TMA, 128-byte swizzle, zero past M and K, so a K tail such as
//     2880's reads as zeros) is wgmma's shared-memory operand B, and the
//     weight is operand A, built in registers.  Each 128-row block of x
//     has a list of tiles: first the 8-bit branch's tiles of 128 columns
//     (their K loop moves 8x the weight bytes of a trunk tile, so they
//     lead rather than form the tail), then the trunk's tiles of BN1
//     columns.  A block walks every gridDim.x-th tile of the whole list
//     (columns fastest, so the blocks in flight share their activation
//     rows in L2).  Warpgroup 0 is the producer: one thread keeps a ring
//     of kStages stages in flight, each the activation box and the tile's
//     weight box (the packed 16 x BN1 bytes of a trunk tile, or the int8
//     128 K rows x 128 columns of an 8-bit tile, TMA with the 128-byte
//     swizzle) behind one "full" and one "empty" mbarrier a stage.
//     Warpgroups 1 and 2 are the consumers, one wgmma group in flight and
//     no block-wide barrier in the K loop:
//       - trunk tile: a consumer owns BN1/2 columns (kSlices m64 slices)
//         and expands its packed bits of a stage into A's fragments
//         (sign_fragment), exactly as w1a8_matmul does;
//       - 8-bit tile: a consumer owns 64 columns (one slice).  int8 wgmma
//         takes no transpose and w8 is N-major (K rows of r bytes), so a
//         lane reads its two adjacent columns of four K rows with 16-bit
//         shared loads and joins them with __byte_perm (int8_fragment).
//         16-bit loads keep the lane -> column map of the trunk tiles (one
//         epilogue for both) where 32-bit loads and a 4 x 4 transpose
//         would need a lane to own four columns, i.e. 256-column 8-bit
//         tiles and 32 KB weight slots.  The four lanes t of a column read
//         K rows 4t + i, which in a 128-byte-wide box all sit on one bank;
//         the box's 128-byte swizzle moves chunk c of row q to c ^ (q & 7),
//         and lanes t = 2, 3 read their rows in the order i ^ 1, so the
//         four rows a load instruction touches have four distinct q & 7
//         and the warp's 16-bit loads are free of bank conflicts.
//     A stage is 16 KB of activations plus a 16 KB weight slot (the int8
//     box; the packed box uses 2-4 KB of it), so the ring holds 6 stages
//     (w1a8_matmul's 8 do not fit; on an H100 4, 5 and 6 stages time
//     within 0.7% of each other at every M, PERF.md).  The trunk tiles are
//     128 or 256 columns (kSlices 2: int32 accumulators in 128 registers a
//     thread under setmaxnreg), whichever finishes the tile list sooner:
//     a 256-column tile takes about 1.8x a 128-column one, and a block's
//     tiles come in rounds of one tile per SM (wide_trunk).
//   * "mma" (any other shape, e.g. the reduced configurations' N or r off
//     16): the first design, tile_gemm.cuh's tile, one block an output
//     tile: ceil(N / BN) trunk tiles, then ceil(r / BN) 8-bit tiles, each
//     a K loop of mma.sync m16n8k32 in 64-byte K stages; a trunk block
//     expands packed signs into its [n][k] shared tile, an 8-bit block
//     transposes 4 x 4 blocks of w8 into the same layout.
//
// The epilogues of both routes keep the Pallas kernel's order of
// operations, f32 with IEEE division (no fast math), read gamma once per
// row of a tile (rows < M only) and write out_dtype (f32, or bf16 rounded
// to nearest even):
//   y1 = float(acc1) * ((beta * lam) * (1 / gamma))
//   y8 = float(acc8) * (alpha / (gamma * w8scale))
// so both outputs equal the plain version's bit for bit.
//
// Measurement switch: DM_SLICES=1|2 forces the trunk tiles' width (the
// library the wrapper loads leaves it unset; tools/decoupled_variants.py
// builds with it to check wide_trunk's 1.8 ratio against both widths).

#include "tile_gemm.cuh"
#include "wgmma_pipe.cuh"

using namespace repro_tile;
namespace sm90 = repro_sm90;

namespace {

// ---- the "mma" route: tile_gemm.cuh's tile ----

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
cudaError_t launch_mma(const int8_t* x, const uint8_t* wp, const int8_t* w8, const float* gamma,
                       const float* const* sc, Out* y1, Out* y8, int m, int k, int n, int r,
                       cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN + (r + BN - 1) / BN, (m + BM - 1) / BM);
  decoupled_matmul_kernel<BM, BN, Out><<<grid, kThreads, 0, stream>>>(
      x, wp, w8, gamma, sc[0], sc[1], sc[2], sc[3], y1, y8, m, k, n, r);
  return cudaGetLastError();
}

// ---- the "wgmma" route ----

constexpr int kBM = 128;  // activation rows a tile: the wgmma's N
constexpr int kBK = 128;  // K bytes a stage: one swizzled row, four k32 steps
constexpr int kStages = 6;  // ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWgThreads = 128 * (1 + kConsumers);
constexpr int kBN8 = 64 * kConsumers;  // 8-bit branch columns a tile: one m64 slice a consumer

template <int kSlices>  // m64 slices of trunk columns a consumer owns
struct DTile {
  static constexpr int kBN1 = 64 * kSlices * kConsumers;  // trunk columns a tile
  static constexpr int kXBytes = kBM * kBK;               // activation box a stage
  static constexpr int k1Bytes = kBK / 8 * kBN1;          // packed box of a trunk tile
  static constexpr int k8Bytes = kBK * kBN8;              // int8 box of an 8-bit tile
  static constexpr int kWBytes = k8Bytes > k1Bytes ? k8Bytes : k1Bytes;  // a stage's weight slot
  // dynamic shared memory, from a 1024-byte-aligned base: the activation
  // stages, the weight slots (each 1024-byte aligned, as the int8 box's
  // swizzle needs), two row-scale buffers per consumer, the barriers
  static constexpr int kWOff = kStages * kXBytes;
  static constexpr int kScaleOff = kWOff + kStages * kWBytes;
  static constexpr int kBarOff = kScaleOff + kConsumers * 2 * kBM * (int)sizeof(float);
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + the base's alignment
  static_assert(kSmem <= 232448, "the ring does not fit in an H100 block's shared memory");
};

// Tile `tile` of the list: row block tile / per_row; in it the t8 8-bit
// tiles of kBN8 columns come first, then the trunk's tiles of bn1.
struct Tile {
  int row0, col0;
  bool eight;
};
__device__ __forceinline__ Tile tile_at(int tile, int t8, int per_row, int bn1) {
  const int j = tile % per_row;
  const bool eight = j < t8;
  return {tile / per_row * kBM, eight ? j * kBN8 : (j - t8) * bn1, eight};
}

// A consumer's place in the ring (stage and phase it waits on next; the
// stage it consumed last, released once that stage's last wgmma is done).
struct Ring {
  int stage = 0, last = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    last = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// After the wgmmas of k32 step s of K stage kt: one group stays in flight
// (the previous step's is done), and once this stage's first step has
// issued, the previous stage (the ring's last) is released for refilling.
__device__ __forceinline__ void step_issued(int s, int kt, const Ring& ring, uint64_t* empty) {
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();
  if (s == 0 && kt > 0) sm90::mbar_arrive(&empty[ring.last]);
}

// The K loop of a trunk tile: a lane's packed bits of a stage (16-bit
// loads of its two columns in every slice), expanded step by step into
// A's fragments (sign_fragment), as in w1a8_matmul.
template <int kSlices>
__device__ __forceinline__ void trunk_k_loop(int (&acc)[kSlices][64], Ring& ring,
                                             const int8_t* xs, const unsigned char* ws,
                                             uint64_t* full, uint64_t* empty, int nk, int wcol,
                                             int kb_lane, int shift) {
  using T = DTile<kSlices>;
  for (int kt = 0; kt < nk; ++kt) {
    sm90::mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* wst = ws + ring.stage * T::kWBytes;
    uint32_t v[kSlices][8];  // packed row kb_lane + 2 j, both columns, every slice
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = *reinterpret_cast<const uint16_t*>(wst + (kb_lane + 2 * j) * T::kBN1 + wcol +
                                                     64 * i);
    const uint64_t desc = sm90::desc_sw128(sm90::smem_addr(xs + ring.stage * T::kXBytes));
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
      step_issued(s, kt, ring, empty);
    }
    ring.advance();
  }
}

// The K loop of an 8-bit tile: a lane's two columns of every K row of the
// stage's int8 box (16-bit loads at the swizzled offsets off8 of a 16-row
// group), joined step by step into A's fragments (int8_fragment).
template <int kSlices>
__device__ __forceinline__ void eight_k_loop(int (&acc)[64], Ring& ring, const int8_t* xs,
                                             const unsigned char* ws, uint64_t* full,
                                             uint64_t* empty, int nk, const int (&off8)[4],
                                             uint32_t sel) {
  using T = DTile<kSlices>;
  for (int kt = 0; kt < nk; ++kt) {
    sm90::mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* wst = ws + ring.stage * T::kWBytes;
    uint32_t v[kBK / 32][2][4];  // K rows 32 s + 16 h + 4 t + .., both columns
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[s][h][i] =
              *reinterpret_cast<const uint16_t*>(wst + (32 * s + 16 * h) * kBN8 + off8[i]);
    const uint64_t desc = sm90::desc_sw128(sm90::smem_addr(xs + ring.stage * T::kXBytes));
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      uint32_t a[4];
      sm90::int8_fragment(v[s][0], v[s][1], sel, a);
      sm90::wgmma_fence();
      sm90::wgmma_m64n128k32_s8(acc, a, desc + 2 * s, kt > 0 || s > 0);
      step_issued(s, kt, ring, empty);
    }
    ring.advance();
  }
}

template <class Out>
__device__ __forceinline__ void store_slice(const int (&d)[64], const float* sc,
                                            Out* __restrict__ out, int ld, int ncols, int row0,
                                            int col, int rows, int t) {
  if (col >= ncols) return;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * j + 2 * t + e;
      if (q < rows) {
        const float s = sc[q];
        sm90::store_pair(out + (size_t)(row0 + q) * ld + col, (float)d[4 * j + e] * s,
                         (float)d[4 * j + 2 + e] * s);
      }
    }
}

template <int kSlices, class Out>
__global__ void __launch_bounds__(kWgThreads, 1)
decoupled_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_w1,
                       const __grid_constant__ CUtensorMap tmap_w8,
                       const float* __restrict__ gamma, const float* __restrict__ lam_p,
                       const float* __restrict__ w8s_p, const float* __restrict__ alpha_p,
                       const float* __restrict__ beta_p, Out* __restrict__ y1,
                       Out* __restrict__ y8, int m, int k, int n, int r) {
  using T = DTile<kSlices>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  const unsigned char* ws = smem + T::kWOff;
  float* scales = reinterpret_cast<float*>(smem + T::kScaleOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kStages;

  const int t8 = (r + kBN8 - 1) / kBN8, per_row = t8 + (n + T::kBN1 - 1) / T::kBN1;
  const int tiles = (m + kBM - 1) / kBM * per_row, nk = (k + kBK - 1) / kBK;
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
        const Tile tt = tile_at(tile, t8, per_row, T::kBN1);
        const uint32_t bytes = T::kXBytes + (tt.eight ? T::k8Bytes : T::k1Bytes);
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round finds every stage free
          sm90::mbar_expect_tx(&full[stage], bytes);
          sm90::tma_load_2d(xs + stage * T::kXBytes, &tmap_x, &full[stage], kt * kBK, tt.row0);
          unsigned char* wdst = smem + T::kWOff + stage * T::kWBytes;
          if (tt.eight)
            sm90::tma_load_2d(wdst, &tmap_w8, &full[stage], tt.col0, kt * kBK);
          else
            sm90::tma_load_2d(wdst, &tmap_w1, &full[stage], tt.col0, kt * (kBK / 8));
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
    // trunk tile: this lane's two columns (2 g, 2 g + 1 of its warp's 16)
    // of slice 0, as a byte offset into a packed row of the tile; the
    // packed rows it reads are (t >> 1) + 2 j, the nibble 4 (t & 1)
    const int wcol = cw * 64 * kSlices + 16 * warp + 2 * g;
    const int kb_lane = t >> 1, shift = 4 * (t & 1);
    // 8-bit tile: this lane's two columns, and the swizzled byte offsets in
    // the int8 box of its load i of a 16-row group: row 4 t + (i ^ (t >> 1))
    const int c8 = cw * 64 + 16 * warp + 2 * g;
    int off8[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * t + (i ^ (t >> 1));
      off8[i] = q * kBN8 + ((((c8 >> 4) ^ (q & 7)) << 4) | (c8 & 15));
    }
    const uint32_t sel = (t & 2) ? 0x1504u : 0x5140u;  // undoes that order
    const float bl = *beta_p * *lam_p, alpha = *alpha_p, w8s = *w8s_p;

    int acc[kSlices][64];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0;

    Ring ring;
    int round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x, ++round) {
      const Tile tt = tile_at(tile, t8, per_row, T::kBN1);
      const int rows = min(kBM, m - tt.row0);
      // the row's scale, loaded under the MMAs (once per row, rows < M only)
      const float gv = tid < rows ? gamma[tt.row0 + tid] : 1.0f;
      if (tt.eight)
        eight_k_loop<kSlices>(acc[0], ring, xs, ws, full, empty, nk, off8, sel);
      else
        trunk_k_loop<kSlices>(acc, ring, xs, ws, full, empty, nk, wcol, kb_lane, shift);
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[ring.last]);

      // epilogue: this warpgroup's scales of the tile's rows (two buffers,
      // so the next tile's writes cannot meet this tile's reads), then the
      // accumulators straight to device memory, two adjacent columns a store
      float* sc = scales + (cw * 2 + (round & 1)) * kBM;
      sc[tid] = tt.eight ? alpha / (gv * w8s) : bl * (1.0f / gv);
      sm90::named_bar_sync(1 + cw, 128);
      if (tt.eight) {
        store_slice(acc[0], sc, y8, r, r, tt.row0, tt.col0 + c8, rows, t);
      } else {
#pragma unroll
        for (int i = 0; i < kSlices; ++i)
          store_slice(acc[i], sc, y1, n, n, tt.row0, tt.col0 + wcol + 64 * i, rows, t);
      }
    }
  }
}

// The trunk tiles' width: 256 columns where the persistent blocks' rounds
// of such tiles (one tile per SM a round), at 1.8x the time of a
// 128-column tile, end sooner than the rounds of 128-column tiles.  On an
// H100 at pquant-1.3b's FFN that is 256 at 512 rows only (PERF.md).
inline bool wide_trunk(int m, int n, int r, int sms) {
#ifdef DM_SLICES
  return DM_SLICES == 2;
#else
  const long rows = (m + kBM - 1) / kBM, t8 = (r + kBN8 - 1) / kBN8;
  const long rounds_wide = (rows * (t8 + (n + 255) / 256) + sms - 1) / sms;
  const long rounds_narrow = (rows * (t8 + (n + 127) / 128) + sms - 1) / sms;
  return 9 * rounds_wide < 5 * rounds_narrow;
#endif
}

template <int kSlices, class Out>
cudaError_t launch_wgmma(const int8_t* x, const uint8_t* wp, const int8_t* w8,
                         const float* gamma, const float* const* sc, Out* y1, Out* y8, int m,
                         int k, int n, int r, int sms, int device, cudaStream_t s) {
  using T = DTile<kSlices>;
  static std::atomic<bool> smem_allowed[sm90::kMaxDevices];
  CUtensorMap tmap_x, tmap_w1, tmap_w8;
  cudaError_t e = sm90::encode_2d(&tmap_x, x, k, m, k, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = sm90::encode_2d(&tmap_w1, wp, n, k / 8, n, T::kBN1, kBK / 8,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = sm90::encode_2d(&tmap_w8, w8, r, k, r, kBN8, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  const auto kernel = decoupled_wgmma_kernel<kSlices, Out>;
  if (e == cudaSuccess) e = sm90::allow_smem(kernel, T::kSmem, device, smem_allowed);
  if (e != cudaSuccess) return e;
  const int per_row = (r + kBN8 - 1) / kBN8 + (n + T::kBN1 - 1) / T::kBN1;
  const int tiles = (m + kBM - 1) / kBM * per_row;
  kernel<<<min(tiles, sms), kWgThreads, T::kSmem, s>>>(tmap_x, tmap_w1, tmap_w8, gamma, sc[0],
                                                       sc[1], sc[2], sc[3], y1, y8, m, k, n, r);
  return cudaGetLastError();
}

// The route of a shape: wgmma needs K, N and r multiples of 16 (the byte
// strides of the TMA boxes).
inline bool wgmma_route(int k, int n, int r) { return k % 16 == 0 && n % 16 == 0 && r % 16 == 0; }

template <class Out>
cudaError_t launch(const int8_t* x, const uint8_t* wp, const int8_t* w8, const float* gamma,
                   const float* const* sc, void* y1_v, void* y8_v, int m, int k, int n, int r,
                   int device, cudaStream_t s) {
  Out* y1 = static_cast<Out*>(y1_v);
  Out* y8 = static_cast<Out*>(y8_v);
  if (wgmma_route(k, n, r)) {
    int sms = 0;
    const cudaError_t e = sm90::sm_count(device, &sms);
    if (e != cudaSuccess) return e;
    return wide_trunk(m, n, r, sms)
               ? launch_wgmma<2, Out>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, sms, device, s)
               : launch_wgmma<1, Out>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, sms, device, s);
  }
  return big_tiles(m, n + r, device)
             ? launch_mma<128, 128, Out>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s)
             : launch_mma<64, 64, Out>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, s);
}

}  // namespace

// The route decoupled_matmul_launch takes for (m, k, n, r): 1 wgmma, 0 mma.
extern "C" int decoupled_matmul_route(int m, int k, int n, int r) {
  return wgmma_route(k, n, r) ? 1 : 0;
}

// Plain C entry point (bound with ctypes): x (m, k) i8, wp (k/8, n) u8,
// w8 (k, r) i8, gamma (m,) f32, lam / w8scale / alpha / beta one f32 each,
// y1 (m, n) and y8 (m, r) of out_dtype (0 f32, 1 bf16), all device
// pointers; k a multiple of 16, r a multiple of 4, x 16-byte and w8 4-byte
// aligned (x, wp and w8 16-byte aligned on the wgmma route).  Returns the
// cudaError_t of the launch and never synchronizes.
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
    switch (out_dtype) {
      case kF32: e = launch<float>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, device, s); break;
      case kBF16:
        e = launch<__nv_bfloat16>(x, wp, w8, gamma, sc, y1, y8, m, k, n, r, device, s);
        break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
