// Shared pieces of the prefill-tier integer GEMM kernels (w1a8_matmul.cu,
// decoupled_matmul.cu; int8_matmul.cu takes the primitives — mma_s8,
// cp_async16, store_out, transpose4x4, Int8B::block_of, big_tiles — for
// its own tile): one block
// computes a BM x BN tile of
// int8 x int8 -> int32 products on the tensor cores with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//
// Block shape: 8 warps (256 threads) in a 2 x 4 grid over the tile, each
// warp owning (BM/2) x (BN/4) outputs as (BM/32) x (BN/32) m16n8 MMA
// tiles held in int32 registers.  K advances 64 bytes per stage through
// two shared-memory buffers:
//
//   * the activation tile (BM x 64 int8, row-major, K contiguous) arrives
//     by cp.async, 16 bytes a thread, zero-filled past the last row and
//     past K (so a ragged edge adds nothing to the sums);
//   * the weight tile is stored [n][k] (K contiguous per column), which is
//     the layout of the MMA's .col B fragment.  Its source differs by
//     branch: PackedB expands each packed byte (bit b of byte k of column
//     n is weight row 8k + b, bit 1 -> +1) into eight int8 signs stored
//     along K; Int8B transposes 4 x 4 byte blocks of a (K, N) row-major
//     int8 matrix in registers (ldmatrix.trans moves 16-bit elements, so
//     it cannot transpose int8).  Both load the next stage into registers
//     before the MMAs of the current one and store it after them, so the
//     global loads overlap the tensor-core work.
//
// Shared rows are 80 bytes apart (64 + 16 of padding): the fragment reads
// (lane = 4 g + t reads word t of row g) then touch 32 distinct banks.
//
// The int32 sums are exact in any order; the f32 epilogues are the
// callers', in the Pallas kernels' order of operations.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_tile {

constexpr int kThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kBK = 64;        // K bytes per stage: two k32 MMA steps
constexpr int kLd = kBK + 16;  // shared row stride in bytes

template <int BM, int BN>
struct Shape {
  static_assert(BM % 32 == 0 && BN % 32 == 0, "tile must split into 2 x 4 warps of m16n8 tiles");
  static constexpr int kWM = BM / kWarpsM, kWN = BN / kWarpsN;  // warp tile
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;            // MMA tiles per warp
  static constexpr int kAChunks = BM * kBK / 16 / kThreads;      // cp.async per thread per stage
  static_assert(kAChunks >= 1 && BN * kBK / 16 >= kThreads, "tile too small for 256 threads");
};

template <int BM, int BN>
struct Smem {
  alignas(16) int8_t a[2][BM * kLd];
  alignas(16) int8_t b[2][BN * kLd];
};

// Output types, selected by the wrappers' out_dtype code.
enum OutCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four sign bits (bit j -> weight j) as four int8 lanes of +1 (bit set) or -1.
__device__ __forceinline__ uint32_t nibble_signs(uint32_t nib) {
  const uint32_t ones = (nib * 0x00204081u) & 0x01010101u;  // bit j -> byte j, 0 or 1
  return __vsub4(ones << 1, 0x01010101u);                     // 0 / 2 -> -1 / +1 per byte
}

// The activation rows [row0, row0 + BM) x K bytes [k0, k0 + 64) of x
// (m x k int8, row-major, k a multiple of 16) into `dst` by cp.async.
template <int BM, int BN>
__device__ __forceinline__ void load_a(int8_t* dst, const int8_t* __restrict__ x, int m, int k,
                                       int row0, int k0) {
#pragma unroll
  for (int j = 0; j < Shape<BM, BN>::kAChunks; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / (kBK / 16), c = idx % (kBK / 16);
    const int row = row0 + r, kk = k0 + c * 16;
    const bool ok = row < m && kk < k;
    // a zero-byte copy still needs a valid address: point it at x itself
    cp_async16(dst + r * kLd + c * 16, ok ? x + (size_t)row * k + kk : x, ok ? 16 : 0);
  }
}

// B source: the packed sign matrix wp (k/8 x n uint8, row-major), columns
// [col0, col0 + BN).  A warp reads 32 neighbouring bytes of one packed row.
template <int BN>
struct PackedB {
  static constexpr int kPer = kBK / 8 * BN / kThreads;  // packed bytes per thread per stage
  const uint8_t* __restrict__ wp;
  int n, kbytes, col0;
  uint32_t v[kPer];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int kb = k0 / 8 + idx / BN, col = col0 + idx % BN;
      // past K the activations are zero, so any sign will do
      v[j] = col < n && kb < kbytes ? __ldg(wp + (size_t)kb * n + col) : 0u;
    }
  }
  __device__ __forceinline__ void store(int8_t* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint2*>(dst + (idx % BN) * kLd + (idx / BN) * 8) =
          make_uint2(nibble_signs(v[j] & 0xFu), nibble_signs(v[j] >> 4));
    }
  }
};

// A 4 x 4 byte block: v[r] holds four columns of row r; t[c] = column c
// down the four rows (byte r of t[c] is byte c of v[r]).
__device__ __forceinline__ void transpose4x4(const uint32_t (&v)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// B source: an int8 matrix w (k x n, row-major, n a multiple of 4),
// columns [col0, col0 + BN), transposed into [n][k].  Each thread moves
// 4 x 4 byte blocks: four words down K (four columns each) become four
// words along K (one column each).  Within a warp, lanes take 8 column
// groups x 4 K groups, so each load instruction reads 32 contiguous bytes
// of 4 rows.
template <int BN>
struct Int8B {
  static constexpr int kPer = kBK * BN / 16 / kThreads;  // 4 x 4 blocks per thread per stage
  const int8_t* __restrict__ w;
  int n, k, col0;
  uint32_t v[kPer][4];

  __device__ __forceinline__ static void block_of(int idx, int& cg, int& kg) {
    const int rest = idx / 32;
    cg = (rest % (BN / 32)) * 8 + idx % 8;  // column group (4 columns)
    kg = (rest / (BN / 32)) * 4 + (idx / 8) % 4;  // K group (4 rows)
  }
  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int cg, kg;
      block_of(threadIdx.x + j * kThreads, cg, kg);
      const int col = col0 + 4 * cg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + 4 * kg + i;
        v[j][i] = col < n && kk < k
                      ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)kk * n + col))
                      : 0u;
      }
    }
  }
  __device__ __forceinline__ void store(int8_t* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int cg, kg;
      block_of(threadIdx.x + j * kThreads, cg, kg);
      uint32_t out[4];
      transpose4x4(v[j], out);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(dst + (4 * cg + i) * kLd + 4 * kg) = out[i];
    }
  }
};

template <int BM, int BN>
struct Acc {
  int c[Shape<BM, BN>::kMT][Shape<BM, BN>::kNT][4];
};

// The MMAs of one stage: acc += A tile (BM x 64) x B tile (64 x BN).
template <int BM, int BN>
__device__ __forceinline__ void mma_stage(const int8_t* as, const int8_t* bs, Acc<BM, BN>& acc) {
  using S = Shape<BM, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 32) {
    uint32_t a[S::kMT][4], b[S::kNT][2];
#pragma unroll
    for (int mi = 0; mi < S::kMT; ++mi) {
      const int8_t* p = as + (wm * S::kWM + mi * 16 + g) * kLd + ks + t * 4;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * kLd);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * kLd + 16);
    }
#pragma unroll
    for (int ni = 0; ni < S::kNT; ++ni) {
      const int8_t* p = bs + (wn * S::kWN + ni * 8 + g) * kLd + ks + t * 4;
      b[ni][0] = lds32(p);
      b[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < S::kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::kNT; ++ni) mma_s8(acc.c[mi][ni], a[mi], b[ni]);
  }
}

// acc = x[row0 : row0 + BM, :] @ B over all of K, double-buffered: the
// next stage's activations (cp.async) and weights (registers) are in
// flight while the current stage's MMAs run.
template <int BM, int BN, class BSrc>
__device__ __forceinline__ void gemm_tile(Smem<BM, BN>& sm, const int8_t* __restrict__ x, int m,
                                          int k, int row0, BSrc& bsrc, Acc<BM, BN>& acc) {
  using S = Shape<BM, BN>;
#pragma unroll
  for (int mi = 0; mi < S::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[mi][ni][e] = 0;
  const int nk = (k + kBK - 1) / kBK;
  load_a<BM, BN>(sm.a[0], x, m, k, row0, 0);
  cp_async_commit();
  bsrc.load(0);
  bsrc.store(sm.b[0]);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a<BM, BN>(sm.a[cur ^ 1], x, m, k, row0, (kt + 1) * kBK);
      cp_async_commit();
      bsrc.load((kt + 1) * kBK);
    }
    mma_stage<BM, BN>(sm.a[cur], sm.b[cur], acc);
    if (more) bsrc.store(sm.b[cur ^ 1]);
    cp_async_wait_all();
    __syncthreads();
  }
}

// out[row, col] = float(acc) * scale(row) for the rows < m and columns <
// ncols of the tile at (row0, col0); `out` has row stride ld.  scale(row)
// is read once per row, only for rows that exist.
template <int BM, int BN, class Out, class Scale>
__device__ __forceinline__ void store_tile(const Acc<BM, BN>& acc, int row0, int col0, int m,
                                           int ncols, Out* __restrict__ out, int ld,
                                           Scale scale) {
  using S = Shape<BM, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < S::kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * S::kWM + mi * 16 + g + 8 * h;
      if (row >= m) continue;
      const float s = scale(row);
      Out* orow = out + (size_t)row * ld;
#pragma unroll
      for (int ni = 0; ni < S::kNT; ++ni) {
        const int col = col0 + wn * S::kWN + ni * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < ncols) store_out(orow + col + e, (float)acc.c[mi][ni][2 * h + e] * s);
      }
    }
}

// The tile shape of a launch: 128 x 128 once that fills the card with
// blocks, else 64 x 64 (more, smaller blocks for short or narrow products).
inline bool big_tiles(int m, int cols, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long blocks = (long)((m + 127) / 128) * ((cols + 127) / 128);
  return blocks >= sms;
}

}  // namespace repro_tile
