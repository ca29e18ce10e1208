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
// The query rows of one (slot, KV head) are r = t * G + g (TG = T * G of
// them), so decode, GQA groups and chunk slices are one problem.
//
// What bounds it on an H100: the bytes of the live K/V pages.  Each query
// row does 4 D flops per resident column against 2 D values of K and V,
// half a flop per byte at f32 decode and 32 at a 64-row slice of one
// head, against the ~20 flops per byte (67 TFLOP/s f32 over 3.35 TB/s) at
// which the cores would be the limit.  So decode must keep enough page
// bytes in flight to run at the memory's rate, and no slot's long context
// may serialise one block; a 64-row slice must spread its f32 FFMA work
// (no tensor cores: TF32 or bf16 P would break the 1e-5 tolerance) and
// feed it from shared memory, which reads 128 bytes a cycle an SM.  What
// measures showed binds in practice is latency: each block costs a fixed
// chain (its context, its first data, the merges; tools/paged_breakdown.py).
//
// Design.  One launch; a thread-block cluster of S blocks (S = 1-8, the
// "splits") per (slot, KV head, group of query rows).  Of the P pages up
// to the block's last attended column (never past kv_lens, so a table
// entry past the used prefix is never read), the cluster's block of rank
// k walks the k-th contiguous range of ceil(P / S) pages and keeps its own
// online-softmax state (m, l, acc) per row.  The blocks of ranks 1.. send
// their states to rank 0 over DSMEM (st.async completing on rank 0's
// mbarrier, as the decode GEMVs do, gemv_mma.cuh), which merges them in
// rank order and writes the output.
// A block whose range is empty (a slot shorter than S pages) sends m =
// -1e30, l = 0, acc = 0, which the merge weighs by exp(-1e30 - M) = 0
// (rank 0 always holds column 0, so M is a real score).  S comes from the
// static shapes alone (make_plan: table width, B, Hkv and TG), never from
// kv_lens, so the host never reads the device; the ranges are cut on the
// device.
//
// Two routes, chosen by shape (make_plan, exported as paged_attention_route):
//   split  (TG < 32, or D not a multiple of 32): a block takes up to 8
//          query rows; its 4 warps take the range's pages in turn, each
//          with its own ring of 2 pages staged by cp.async (16 bytes a
//          copy, zero-filled past the slot's columns), so every warp has a
//          page in flight while it scores the last.  A lane owns one query
//          row, one column of each pass over a page and a share of D (its
//          q share in registers), and keeps its own online softmax: a page
//          costs no cross-lane work but the sum of a score's shares.  A
//          GQA group's rows read each page once.  At the end a warp merges
//          its lanes over shuffles, the block its warps in shared memory,
//          then the cluster its blocks.
//   tile   (TG >= 32, D a multiple of 32 up to 128): a block takes 64 query
//          rows and walks its range 32 columns at a time through a ring of
//          2 stages (cp.async, one block barrier a tile).  A thread owns
//          4 rows x 4 columns of scores and 4 rows x D / 8 dims of the
//          accumulator (register micro-tiles, so that each value read from
//          shared memory feeds 4 FMAs); P goes through shared memory to the
//          warp that owns its rows.
// Staged rows are 16-byte chunks XOR-swizzled by row, so the score loads
// of 8 columns hit distinct banks.  Numerics: scores, softmax state and
// the accumulator are f32 whatever the pool's type; score = dot(q, k) *
// scale; a masked column's probability is forced to 0; expf and IEEE
// division, no fast math.  The kernel reassociates the softmax reduction,
// so it matches the plain version to f32 rounding, not bit for bit.

#include <atomic>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_mma.cuh"     // cluster_arrive / cluster_wait, remote, st_async
#include "tile_gemm.cuh"    // cp_async16, cp_async_commit, cp_async_wait_all
#include "wgmma_pipe.cuh"   // mbarriers, allow_smem

namespace {

namespace gm = repro_gemv;
namespace rt = repro_tile;
namespace sm90 = repro_sm90;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;     // a portable cluster
constexpr int kTargetBlocks = 256;      // split route: blocks the splits aim at
constexpr int kTileTargetBlocks = 1024; // tile route
constexpr int kMinPages = 2;      // pages a split keeps at least
constexpr int kSplitRows = 8;     // most query rows of a split-route block
constexpr int kSplitStages = 2;   // pages of a warp's ring
constexpr int kTileRows = 64;
constexpr int kThreadRows = 4;   // tile: rows of a thread's micro-tiles
constexpr int kTileCols = 32;
constexpr int kTileStages = 2;
constexpr int kPLd = kTileCols + 4;  // row stride of the P tile, in floats
constexpr int kMaxD = 128;           // head dims the kernel takes
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr float kNegInf = -1e30f;

// A measurement (tools/paged_breakdown.py) may build the kernel cut after
// a step (PA_CUT 0: the context and the cluster barrier; 1: + the copies
// of q and the pages; 2: + the scores, P.V and the block's merge; 3, the
// default: whole, with the cluster's merge and the output), with its
// splits forced (PA_SPLITS, 0 the plan's), or marking each block's steps
// (PA_MARKS: %globaltimer at kMarks points into paged_attention_marks).
#ifndef PA_CUT
#define PA_CUT 3
#endif
#ifndef PA_SPLITS
#define PA_SPLITS 0
#endif
#ifndef PA_MARKS
#define PA_MARKS 0
#endif
// entry, context, first data, walked, block merged, done; then within the
// first tile or page: scores, softmax, P.V
constexpr int kMarks = 9;

#if PA_MARKS
__device__ unsigned long long* paged_attention_marks;  // blocks x kMarks, ns
#endif

__device__ __forceinline__ void mark(int i) {
#if PA_MARKS
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const size_t blk = blockIdx.x + gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    paged_attention_marks[blk * kMarks + i] = t;
  }
#endif
}

// ---- the plan: route, rows a block, splits, pages a split (static shapes) ----

struct Plan {
  int tile;    // 1 the tile route, 0 the split route
  int rows;    // query rows a block takes
  int splits;  // blocks of a cluster, one page range each
  int mb;      // table width
};

// ---- shared memory ----
//   q     the block's query rows as f32 (rows x D)
//   ring  the staged K/V rows (split: per warp 2 pages of K then V rows;
//         tile: 2 stages of 32 K rows then 32 V rows); after the walk it
//         holds the warps' states (split), the block's state `fin`, and
//         rank 0's merge weights `wts`
//   p     the tile route's P (32 x kPLd f32)
//   recv  rank 0's slots for ranks 1..S-1 (rows x (D + 2) f32 each,
//         16-byte aligned)
//   bar   rank 0's mbarrier
//   tbl   the slot's table row
// A state is rows x D accumulator values, then rows m, then rows l.
struct Layout {
  int q_off, ring_off, p_off, fin_off, wts_off, recv_off, bar_off, tbl_off, total;
};

inline int align128(long v) { return (int)((v + 127) / 128 * 128); }

// A state's floats (rows x D acc, rows m, rows l), rounded to 16 bytes.
__host__ __device__ inline int state_floats(int rows, int d) { return (rows * (d + 2) + 3) & ~3; }

inline Layout make_layout(const Plan& p, int d, int bs, int elem) {
  const long row_bytes = (long)d * elem;
  const long state = 4L * state_floats(p.rows, d);
  Layout l;
  l.q_off = 0;
  l.ring_off = align128((long)p.rows * d * 4);
  long ring, fin_in_ring;
  if (p.tile) {
    ring = (long)kTileStages * 2 * kTileCols * row_bytes;
    fin_in_ring = 0;
  } else {
    ring = (long)kWarps * kSplitStages * 2 * bs * row_bytes;
    fin_in_ring = (long)kWarps * p.rows * (d + 2) * 4;  // the warps' states
  }
  l.fin_off = l.ring_off + (int)fin_in_ring;
  l.wts_off = l.fin_off + (int)state;
  const long used = fin_in_ring + state + (long)p.rows * (p.splits + 1) * 4;
  l.p_off = align128(l.ring_off + (ring > used ? ring : used));
  l.recv_off = align128(l.p_off + (p.tile ? (long)kTileRows * kPLd * 4 : 0));
  l.bar_off = align128(l.recv_off + (long)(p.splits - 1) * state);
  l.tbl_off = l.bar_off + 8;
  l.total = l.tbl_off + p.mb * 4;
  return l;
}

inline Plan make_plan(int b, int t, int hq, int hkv, int d, int mb) {
  const int tg = t * (hq / hkv);
  Plan p;
  p.tile = tg >= kTileRows / 2 && d % 32 == 0 && d <= kMaxD;
  if (p.tile) {
    p.rows = kTileRows;
  } else {
    p.rows = 1;
    while (p.rows < tg && p.rows < kSplitRows) p.rows <<= 1;
  }
  const long groups = (long)b * hkv * ((tg + p.rows - 1) / p.rows);
  const long target = p.tile ? kTileTargetBlocks : kTargetBlocks;
  p.splits = 1;
  while (p.splits < kMaxSplits && groups * p.splits < target &&
         (mb + 2 * p.splits - 1) / (2 * p.splits) >= kMinPages)
    p.splits <<= 1;
  if (PA_SPLITS) p.splits = PA_SPLITS;
  p.mb = mb;
  // the tile route keeps a merge slot of 64 x (D + 2) floats for each split
  // past the first: at D 128, 8 splits need 340 KB; halve them until a
  // block's f32 layout fits (its layout does not depend on the block size)
  while (p.tile && p.splits > 1 && make_layout(p, d, 1, 4).total > kMaxSmem) p.splits >>= 1;
  return p;
}

// The largest power of two up to 32 that divides the block size.
inline int column_group(int bs) {
  int cg = 1;
  while (cg < 32 && bs % (2 * cg) == 0) cg <<= 1;
  return cg;
}

// Columns a split-route pass scores: a warp's 32 lanes take `rows` rows
// of cg columns (cg dividing the block size), the rest split D.
inline int split_cg(int rows, int bs) {
  const int cg = column_group(bs);
  return cg < 32 / rows ? cg : 32 / rows;
}

// XOR mask of the staged rows' chunks: the largest 2^k - 1 with 2^k <= 8
// dividing the chunks of a row.
inline int swizzle_mask(int units) {
  int s = 1;
  while (s < 8 && units % (2 * s) == 0) s <<= 1;
  return s - 1;
}

struct Args {
  const void* q;
  const uint8_t* kpool;
  const uint8_t* vpool;
  const int* table;
  const int* start;
  const int* kv_lens;
  void* out;
  int q_code, t, hq, hkv, d, bs, mb;
  int rows, splits;
  int units;  // 16-byte chunks of a K/V row
  int swz;    // chunk c of staged row i lies at c ^ (i & swz)
  int cg;     // split route: columns of a pass (split_cg)
  float scale;
  Layout lay;
};

// ---- small pieces ----

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVals = 4;  // values of a 16-byte chunk
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVals = 8;
};

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack2(uint32_t w, float* f) {  // two bf16, exactly
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  unpack2(u.x, f);
  unpack2(u.y, f + 2);
  unpack2(u.z, f + 4);
  unpack2(u.w, f + 6);
}

// Four values (group g = elements 4 g .. 4 g + 3) of a staged row.
__device__ __forceinline__ float4 load_quad(const uint8_t* row, int g, int sw, const float*) {
  return *reinterpret_cast<const float4*>(row + ((g ^ sw) << 4));
}
__device__ __forceinline__ float4 load_quad(const uint8_t* row, int g, int sw,
                                            const __nv_bfloat16*) {
  const uint2 w = *reinterpret_cast<const uint2*>(row + (((g >> 1) ^ sw) << 4) + (g & 1) * 8);
  float f[4];
  unpack2(w.x, f);
  unpack2(w.y, f + 2);
  return make_float4(f[0], f[1], f[2], f[3]);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's place in the problem and the pages it walks.
struct Ctx {
  int b, h, rank, g, tg, row0, nrows, st, len, c_lo, c_hi;  // columns [c_lo, c_hi)
  int lo, hi;                                              // pages [lo, hi)
};

// The block's context, and the slot's table row staged in shared memory
// (tbl): loaded at once with start and kv_lens, before the lengths are
// known, so the page copies wait for one load latency, not two.  Rank k
// of S takes the k-th of S contiguous ranges of ceil(P / S) pages of the
// P pages the block's rows attend (none where k ceil(P / S) >= P).  Ends
// in a barrier.
__device__ __forceinline__ Ctx context(const Args& a, int* tbl) {
  Ctx c;
  c.rank = blockIdx.x;  // the cluster spans grid x
  c.h = blockIdx.y % a.hkv;
  c.b = blockIdx.z;
  const int* row = a.table + (size_t)c.b * a.mb;
  const int st = a.start[c.b], kl = a.kv_lens[c.b];
  const int first = threadIdx.x < a.mb ? row[threadIdx.x] : 0;
  for (int i = threadIdx.x + kThreads; i < a.mb; i += kThreads) tbl[i] = row[i];
  if (threadIdx.x < a.mb) tbl[threadIdx.x] = first;
  c.g = a.hq / a.hkv;
  c.tg = a.t * c.g;
  c.row0 = (blockIdx.y / a.hkv) * a.rows;
  c.nrows = min(a.rows, c.tg - c.row0);
  c.st = st;
  c.len = min(max(kl, 1), a.mb * a.bs);
  // the last column any row of the block attends bounds the walk
  const int ncols = min(c.st + (c.row0 + c.nrows - 1) / c.g, c.len - 1) + 1;
  const int npages = (ncols + a.bs - 1) / a.bs;
  const int per = (npages + a.splits - 1) / a.splits;
  c.lo = min(npages, c.rank * per);
  c.hi = min(npages, c.lo + per);
  c.c_lo = c.lo * a.bs;
  c.c_hi = min(c.hi * a.bs, ncols);
  __syncthreads();  // tbl staged
  return c;
}

// The last column row `r` (local) attends, or -1 for a pad row.
__device__ __forceinline__ int row_limit(const Ctx& c, int r) {
  return r < c.nrows ? min(c.st + (c.row0 + r) / c.g, c.len - 1) : -1;
}

__device__ __forceinline__ size_t q_index(const Args& a, const Ctx& c, int r, int e) {
  const int rr = c.row0 + r, tt = rr / c.g, gg = rr - tt * c.g;
  return (((size_t)c.b * a.t + tt) * a.hq + (size_t)c.h * c.g + gg) * a.d + e;
}

// Rank 0 starts the mbarrier that the other ranks' states complete; every
// block arrives on the cluster barrier (waited on before the first DSMEM
// store, so no block writes into one that has not started).
__device__ __forceinline__ void cluster_start(const Args& a, const Ctx& c, uint8_t* smem) {
  if (a.splits == 1) return;
  if (c.rank == 0 && threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + a.lay.bar_off);
    sm90::mbar_init(bar, 1);
    sm90::mbar_expect_tx(bar, (a.splits - 1) * state_floats(a.rows, a.d) * 4);
    sm90::mbar_fence_init();
  }
  gm::cluster_arrive();
}

// The block's query rows into qs as f32 (zeros past the last row), one
// cp.async group: f32 rows copied in 16-byte chunks, bf16 rows widened
// through registers.  q is 16-byte aligned (the wrapper checks).
__device__ __forceinline__ void stage_q(const Args& a, const Ctx& c, float* qs, bool any) {
  if (any && a.q_code == 0) {
    const float* q = static_cast<const float*>(a.q);
    const int chunks = a.d / 4;
    for (int i = threadIdx.x; i < a.rows * chunks; i += kThreads) {
      const int r = i / chunks, u = i - r * chunks;
      const bool ok = r < c.nrows;
      rt::cp_async16(qs + r * a.d + 4 * u, ok ? q + q_index(a, c, r, 4 * u) : q, ok ? 16 : 0);
    }
  } else if (any) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const int chunks = a.d / 8;
    for (int i = threadIdx.x; i < a.rows * chunks; i += kThreads) {
      const int r = i / chunks, u = i - r * chunks;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (r < c.nrows) w = __ldg(reinterpret_cast<const uint4*>(q + q_index(a, c, r, 8 * u)));
      float f[8];
      unpack(w, f);
      float4* dst = reinterpret_cast<float4*>(qs + r * a.d + 8 * u);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  rt::cp_async_commit();
}

// One staged K/V row: 16-byte chunks by cp.async, zeros where !ok.
__device__ __forceinline__ void stage_row(const Args& a, uint8_t* kd, uint8_t* vd, int i,
                                          size_t src, bool ok, int u) {
  const int dst = i * a.units * 16 + ((u ^ (i & a.swz)) << 4);
  rt::cp_async16(kd + dst, ok ? a.kpool + src + u * 16 : a.kpool, ok ? 16 : 0);
  rt::cp_async16(vd + dst, ok ? a.vpool + src + u * 16 : a.vpool, ok ? 16 : 0);
}

// The block's state (fin) to rank 0, or rank 0's merge of all S in rank
// order into the output.  fin and the recv slots: rows x D acc, rows m,
// rows l.  Rank 0 first takes each row's maximum and the S weights
// exp(m_k - M) into the free ring (wts), then one thread a (row, 4
// dims) sums the S accumulators and divides by l (IEEE).
__device__ __forceinline__ void finish(const Args& a, const Ctx& c, uint8_t* smem) {
  const int d = a.d, rows = a.rows, state = state_floats(rows, d), ns = a.splits;
  const float* fin = reinterpret_cast<const float*>(smem + a.lay.fin_off);
  float* recv = reinterpret_cast<float*>(smem + a.lay.recv_off);
  if (PA_CUT < 3) {
    if (ns > 1) gm::cluster_wait();
    return;
  }
  if (ns > 1) {
    gm::cluster_wait();
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + a.lay.bar_off);
    if (c.rank) {
      const uint32_t rbar = gm::remote(bar, 0);
      const uint32_t dst = gm::remote(recv + (c.rank - 1) * state, 0);
      for (int i = threadIdx.x; i < state / 2; i += kThreads) {
        const float2 v = reinterpret_cast<const float2*>(fin)[i];
        gm::st_async(dst + 8 * i, make_uint2(__float_as_uint(v.x), __float_as_uint(v.y)), rbar);
      }
      return;
    }
    sm90::mbar_wait(bar, 0);
  }
  // rank k's state: fin (k = 0) or recv slot k - 1
  auto st = [&](int k) { return k ? recv + (k - 1) * state : fin; };
  float* wts = reinterpret_cast<float*>(smem + a.lay.wts_off);  // rows x (S weights, 1 / L)
  for (int r = threadIdx.x; r < c.nrows; r += kThreads) {
    float mx = kNegInf;
    for (int k = 0; k < ns; ++k) mx = fmaxf(mx, st(k)[rows * d + r]);
    float l = 0.f;
    for (int k = 0; k < ns; ++k) {
      const float w = expf(st(k)[rows * d + r] - mx);
      wts[r * (ns + 1) + k] = w;
      l += w * st(k)[rows * d + rows + r];
    }
    wts[r * (ns + 1) + ns] = l;
  }
  __syncthreads();
  const int groups = d / 4;
  for (int i = threadIdx.x; i < c.nrows * groups; i += kThreads) {
    const int r = i / groups, e = 4 * (i - r * groups);
    const float* w = wts + r * (ns + 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ns; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(st(k) + r * d + e);
      acc.x += w[k] * v.x;
      acc.y += w[k] * v.y;
      acc.z += w[k] * v.z;
      acc.w += w[k] * v.w;
    }
    const float l = w[ns];
    const float4 o = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
    const size_t k = q_index(a, c, r, e);
    if (a.q_code) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + k) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + k) = o;
    }
  }
}

// ---- the split route ----
//
// Lane (s, r, c) = lane (s * rows + r) * cg + c of a warp owns query row r,
// the c-th column of each pass of cg columns over the warp's pages, and
// the staged 16-byte chunks s, s + lpd, ... of D (lpd = 32 / (rows x cg)
// lanes share a column).  Each lane keeps its own online softmax (m, l)
// and accumulator over its columns, so a page costs no cross-lane work but
// the lpd-lane sum of a score; at the end a warp merges its cg column
// lanes' states over shuffles and the block its warps'.  DLM: the D
// values a lane holds, at most.

template <int DLM, typename TKV>
__global__ void __launch_bounds__(kThreads, DLM <= 32 ? 4 : 1) split_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kVals = Elem<TKV>::kVals;
  constexpr int kUM = DLM / kVals > 0 ? DLM / kVals : 1;  // chunks a lane holds, at most
  mark(0);
  int* tbl = reinterpret_cast<int*>(smem + a.lay.tbl_off);
  const Ctx c = context(a, tbl);
  cluster_start(a, c, smem);
  mark(1);
  if (PA_CUT == 0) {
    if (a.splits > 1) gm::cluster_wait();
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d, bs = a.bs, row_bytes = a.units * 16, rows = a.rows, cg = a.cg;
  const int lpd = 32 / (rows * cg);
  const int cl = lane % cg, r = (lane / cg) % rows, s = lane / (cg * rows);
  float* qs = reinterpret_cast<float*>(smem + a.lay.q_off);
  stage_q(a, c, qs, c.lo < c.hi);

  const int lim = row_limit(c, r);
  float m = kNegInf, l = 0.f, acc[kUM][kVals];
#pragma unroll
  for (int k = 0; k < kUM; ++k)
#pragma unroll
    for (int v = 0; v < kVals; ++v) acc[k][v] = 0.f;

  // this warp's pages: lo + warp + kWarps i
  const int n = c.hi > c.lo + warp ? (c.hi - c.lo - warp + kWarps - 1) / kWarps : 0;
  const int stage_bytes = 2 * bs * row_bytes;
  uint8_t* ring = smem + a.lay.ring_off + warp * kSplitStages * stage_bytes;
  const size_t pool_row = (size_t)a.hkv * row_bytes;
  auto fetch = [&](int i) {
    if (i < n) {
      const int p = c.lo + warp + kWarps * i;
      uint8_t* kd = ring + (i % kSplitStages) * stage_bytes;
      const size_t base = ((size_t)tbl[p] * bs * a.hkv + c.h) * row_bytes;
      const int valid = c.c_hi - p * bs;  // rows of the page the walk may use
      for (int idx = lane; idx < bs * a.units; idx += 32) {
        const int rr = idx / a.units, u = idx - rr * a.units;
        stage_row(a, kd, kd + bs * row_bytes, rr, base + rr * pool_row, rr < valid, u);
      }
    }
    rt::cp_async_commit();  // an empty group keeps the count in step
  };
  for (int i = 0; i < kSplitStages; ++i) fetch(i);
  cp_async_wait<kSplitStages>();  // q's group
  __syncthreads();
  mark(2);

  // the lane's share of its query row, in registers where it fits
  constexpr bool kQRegs = DLM <= 32;
  const float* qr = qs + r * d;
  float qreg[kQRegs ? kUM : 1][kVals];
  if constexpr (kQRegs) {
#pragma unroll
    for (int k = 0; k < kUM; ++k) {
      const int u = s + lpd * k;
#pragma unroll
      for (int v = 0; v < kVals; ++v) qreg[k][v] = u < a.units ? qr[u * kVals + v] : 0.f;
    }
  }
  // A page's passes; kFull: every lane holds kUM whole chunks of D (no
  // predicate between the loads, so they go out back to back).
  auto walk = [&](auto full) {
    constexpr bool kFull = decltype(full)::value;
    for (int i = 0; i < n; ++i) {
      cp_async_wait<kSplitStages - 1>();  // page i
      __syncwarp();
      const int p = c.lo + warp + kWarps * i;
      const uint8_t* ks = ring + (i % kSplitStages) * stage_bytes;
      const uint8_t* vs = ks + bs * row_bytes;
      for (int c0 = 0; PA_CUT >= 2 && c0 < bs && p * bs + c0 < c.c_hi; c0 += cg) {
        const int col = c0 + cl, j = p * bs + col, sw = col & a.swz;
        const uint8_t* krow = ks + col * row_bytes;
        const uint8_t* vrow = vs + col * row_bytes;
        float kf[kUM][kVals];
#pragma unroll
        for (int k = 0; k < kUM; ++k) {
          const int u = s + lpd * k;
          if (kFull || u < a.units) {
            unpack(*reinterpret_cast<const uint4*>(krow + ((u ^ sw) << 4)), kf[k]);
          } else {
#pragma unroll
            for (int v = 0; v < kVals; ++v) kf[k][v] = 0.f;
          }
        }
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < kUM; ++k) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int v = 0; v < kVals; ++v) part += qreg[k][v] * kf[k][v];
          } else {
            const float* qu = qr + (s + lpd * k) * kVals;
#pragma unroll
            for (int v = 0; v < kVals; ++v)
              part += (kFull || s + lpd * k < a.units ? qu[v] : 0.f) * kf[k][v];
          }
        }
        for (int o = cg * rows; o < 32; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const bool valid = j <= lim && j < c.c_hi;
        const float sc = valid ? part * a.scale : kNegInf;
        const float mn = fmaxf(m, sc);
        const float pr = valid ? expf(sc - mn) : 0.f;
        const float alpha = expf(m - mn);
        l = l * alpha + pr;
        m = mn;
#pragma unroll
        for (int k = 0; k < kUM; ++k) {
          const int u = s + lpd * k;
          if (kFull || u < a.units) {
            float vf[kVals];
            unpack(*reinterpret_cast<const uint4*>(vrow + ((u ^ sw) << 4)), vf);
#pragma unroll
            for (int v = 0; v < kVals; ++v) acc[k][v] = acc[k][v] * alpha + pr * vf[v];
          }
        }
      }
      __syncwarp();  // the stage is read before the ring refills it
      if (i == 0) mark(6);
      fetch(i + kSplitStages);
    }
  };
  if (a.units == kUM * lpd)
    walk(std::true_type{});
  else
    walk(std::false_type{});

  // the column lanes' states merged over shuffles (pairs, then pairs of
  // pairs), then the warps' in shared memory, in warp order
  for (int o = 1; o < cg; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o), lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo), wa = expf(m - mn), wb = expf(mo - mn);
    l = l * wa + lo * wb;
#pragma unroll
    for (int k = 0; k < kUM; ++k)
#pragma unroll
      for (int v = 0; v < kVals; ++v)
        acc[k][v] = acc[k][v] * wa + __shfl_xor_sync(0xffffffffu, acc[k][v], o) * wb;
    m = mn;
  }
  rt::cp_async_wait_all();
  __syncthreads();
  mark(3);
  const int sst = d + 2;  // a state's stride: D acc, m, l
  float* st = reinterpret_cast<float*>(smem + a.lay.ring_off);  // kWarps x rows states
  if (cl == 0) {
    float* sd = st + (warp * rows + r) * sst;
#pragma unroll
    for (int k = 0; k < kUM; ++k) {
      const int u = s + lpd * k;
      if (u < a.units)
#pragma unroll
        for (int v = 0; v < kVals; v += 2)
          *reinterpret_cast<float2*>(sd + u * kVals + v) = make_float2(acc[k][v], acc[k][v + 1]);
    }
    if (s == 0) {
      sd[d] = m;
      sd[d + 1] = l;
    }
  }
  __syncthreads();
  float* fin = reinterpret_cast<float*>(smem + a.lay.fin_off);
  for (int idx = threadIdx.x; idx < rows * (d + 1); idx += kThreads) {
    const int rr = idx / (d + 1), e = idx - rr * (d + 1);
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st[(w * rows + rr) * sst + d]);
    const int off = e < d ? e : d + 1;  // an acc value, or l
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = st + (w * rows + rr) * sst;
      sum += expf(sw[d] - mx) * sw[off];
    }
    if (e < d) {
      fin[rr * d + e] = sum;
    } else {
      fin[rows * d + rr] = mx;
      fin[rows * d + rows + rr] = sum;
    }
  }
  __syncthreads();
  mark(4);
  finish(a, c, smem);
  mark(5);
}

// ---- the tile route ----

template <int NG, typename TKV>  // NG: D / 32
__global__ void __launch_bounds__(kThreads) tile_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kVals = Elem<TKV>::kVals;
  mark(0);
  int* tbl = reinterpret_cast<int*>(smem + a.lay.tbl_off);
  const Ctx c = context(a, tbl);
  cluster_start(a, c, smem);
  mark(1);
  if (PA_CUT == 0) {
    if (a.splits > 1) gm::cluster_wait();
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rp = lane >> 3, cq = lane & 7;
  constexpr int RT = kThreadRows;
  const int r0 = (warp * 4 + rp) * RT;  // this thread's rows r0 .. r0 + RT - 1
  const int d = a.d, row_bytes = a.units * 16;
  float* qs = reinterpret_cast<float*>(smem + a.lay.q_off);
  float* ps = reinterpret_cast<float*>(smem + a.lay.p_off);
  const int ntiles = c.c_hi > c.c_lo ? (c.c_hi - c.c_lo + kTileCols - 1) / kTileCols : 0;
  stage_q(a, c, qs, ntiles > 0);

  const int stage_bytes = 2 * kTileCols * row_bytes;
  uint8_t* ring = smem + a.lay.ring_off;
  const size_t pool_row = (size_t)a.hkv * row_bytes;
  auto fetch = [&](int i) {
    if (i < ntiles) {
      uint8_t* kd = ring + (i % kTileStages) * stage_bytes;
      for (int idx = threadIdx.x; idx < kTileCols * a.units; idx += kThreads) {
        const int r = idx / a.units, u = idx - r * a.units;
        const int j = c.c_lo + i * kTileCols + r;
        const bool ok = j < c.c_hi;
        size_t src = 0;
        if (ok) {
          const int pg = j / a.bs;
          src = (((size_t)tbl[pg] * a.bs + (j - pg * a.bs)) * a.hkv + c.h) * row_bytes;
        }
        stage_row(a, kd, kd + kTileCols * row_bytes, r, src, ok, u);
      }
    }
    rt::cp_async_commit();
  };
  for (int i = 0; i < kTileStages - 1; ++i) fetch(i);

  float m[RT], l[RT], acc[RT][NG][4];
  int lim[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    lim[r] = row_limit(c, r0 + r);
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[r][k][0] = acc[r][k][1] = acc[r][k][2] = acc[r][k][3] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kTileStages - 2>();  // q's group and tile i
    __syncthreads();  // visible to all; every thread is done with tile i - 1
    if (i == 0) mark(2);
    fetch(i + kTileStages - 1);
    const uint8_t* ks = ring + (i % kTileStages) * stage_bytes;
    const uint8_t* vs = ks + kTileCols * row_bytes;
    const int j0 = c.c_lo + i * kTileCols, nv = min(kTileCols, c.c_hi - j0);
    if (PA_CUT < 2) continue;
    // scores: rows r0 .. r0 + RT - 1 x columns cq + 8 jj
    float sc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[r][jj] = 0.f;
    // NB blocks of 8 columns, a compile-time count (no test between the
    // loads): all 4, or 1 where the tile holds at most 8 valid columns
    auto score = [&](auto nb) {
      constexpr int NB = decltype(nb)::value;
#pragma unroll 2
      for (int u = 0; u < a.units; ++u) {
        float4 qv[RT][kVals / 4];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int v = 0; v < kVals / 4; ++v)
            qv[r][v] = *reinterpret_cast<const float4*>(qs + (r0 + r) * d + u * kVals + 4 * v);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          const int col = cq + 8 * jj;
          float kf[kVals];
          unpack(
              *reinterpret_cast<const uint4*>(ks + col * row_bytes + ((u ^ (col & a.swz)) << 4)),
              kf);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int v = 0; v < kVals / 4; ++v)
              sc[r][jj] += qv[r][v].x * kf[4 * v] + qv[r][v].y * kf[4 * v + 1] +
                           qv[r][v].z * kf[4 * v + 2] + qv[r][v].w * kf[4 * v + 3];
        }
      }
    };
    if (nv > 8)
      score(std::integral_constant<int, 4>{});
    else
      score(std::integral_constant<int, 1>{});
    if (i == 0) mark(6);
    // the online softmax of the tile, a row's 32 columns on 8 lanes
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = kNegInf;
      bool valid[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + cq + 8 * jj;
        valid[jj] = j <= lim[r] && j < c.c_hi;
        sc[r][jj] = valid[jj] ? sc[r][jj] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[r][jj]);
      }
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = valid[jj] ? expf(sc[r][jj] - mn) : 0.f;
        sum += p;
        ps[(r0 + r) * kPLd + cq + 8 * jj] = p;
      }
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][k][e] *= alpha;
    }
    __syncwarp();  // the warp's P rows are written
    if (i == 0) mark(7);
    // P.V: rows r0 .. r0 + RT - 1 x groups cq + 8 k of D
    for (int c0 = 0; c0 < nv; c0 += 4) {
      float w[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(ps + (r0 + r) * kPLd + c0);
        w[r][0] = pr.x;
        w[r][1] = pr.y;
        w[r][2] = pr.z;
        w[r][3] = pr.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int vr = c0 + cc;
        const uint8_t* vrow = vs + vr * row_bytes;
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          const float4 v = load_quad(vrow, cq + 8 * k, vr & a.swz,
                                     static_cast<const TKV*>(nullptr));
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            acc[r][k][0] += w[r][cc] * v.x;
            acc[r][k][1] += w[r][cc] * v.y;
            acc[r][k][2] += w[r][cc] * v.z;
            acc[r][k][3] += w[r][cc] * v.w;
          }
        }
      }
    }
    if (i == 0) mark(8);
  }

  // the block's state into fin (over the ring)
  rt::cp_async_wait_all();
  __syncthreads();
  mark(3);
  float* fin = reinterpret_cast<float*>(smem + a.lay.fin_off);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int k = 0; k < NG; ++k)
        *reinterpret_cast<float4*>(fin + (r0 + r) * d + 4 * (cq + 8 * k)) =
            make_float4(acc[r][k][0], acc[r][k][1], acc[r][k][2], acc[r][k][3]);
    if (cq == 0) {
      fin[kTileRows * d + r0 + r] = m[r];
      fin[kTileRows * d + kTileRows + r0 + r] = l[r];
    }
  }
  __syncthreads();
  mark(4);
  finish(a, c, smem);
  mark(5);
}

// ---- launch ----

// One launch of the route's kernel (DLM 1-4: the tile route with NG =
// DLM), clusters of `splits` blocks along grid x.
template <int DLM, typename TKV>
cudaError_t launch(const Args& a, int b, int groups, int device, cudaStream_t stream) {
  static std::atomic<bool> allowed[sm90::kMaxDevices];
  void (*kern)(Args);
  if constexpr (DLM <= 4)
    kern = tile_kernel<DLM, TKV>;
  else
    kern = split_kernel<DLM, TKV>;
  cudaError_t e = sm90::allow_smem(kern, kMaxSmem, device, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.hkv * groups, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// The D values a split-route lane holds, rounded up to a power of two
// (at least 16, at most 128).
inline int split_dlm(int rows, int d, int bs) {
  const int lpd = 32 / (rows * split_cg(rows, bs));
  const int dl = (d + lpd - 1) / lpd;
  int dlm = 16;
  while (dlm < dl) dlm <<= 1;
  return dlm;
}

template <typename TKV>
cudaError_t dispatch(const Plan& p, const Args& a, int b, int device, cudaStream_t s) {
  const int groups = (a.t * (a.hq / a.hkv) + p.rows - 1) / p.rows;
  if (p.tile) {
    switch (a.d / 32) {
      case 1: return launch<1, TKV>(a, b, groups, device, s);
      case 2: return launch<2, TKV>(a, b, groups, device, s);
      case 3: return launch<3, TKV>(a, b, groups, device, s);
      default: return launch<4, TKV>(a, b, groups, device, s);
    }
  }
  switch (split_dlm(p.rows, a.d, a.bs)) {
    case 16: return launch<16, TKV>(a, b, groups, device, s);
    case 32: return launch<32, TKV>(a, b, groups, device, s);
    case 64: return launch<64, TKV>(a, b, groups, device, s);
    default: return launch<128, TKV>(a, b, groups, device, s);
  }
}

bool shapes_ok(int b, int t, int hq, int hkv, int d, int bs, int mb, int elem) {
  if (b < 1 || t < 1 || hkv < 1 || hq % hkv || d < 8 || d % 8 || d > kMaxD || bs < 1 || mb < 1)
    return false;
  const Plan p = make_plan(b, t, hq, hkv, d, mb);
  return make_layout(p, d, bs, elem).total <= kMaxSmem;
}

}  // namespace

// The plan paged_attention_launch takes for these shapes (no pointer is
// read): the route in bit 0 (1 tile, 0 split), the splits in bits 1-7,
// the rows a block takes from bit 8; -1 for shapes the kernel refuses.
// kv_code: 0 float32 pools, 1 bfloat16.
extern "C" int paged_attention_route(int b, int t, int hq, int hkv, int d, int bs, int mb,
                                     int kv_code) {
  if (!shapes_ok(b, t, hq, hkv, d, bs, mb, kv_code ? 2 : 4)) return -1;
  const Plan p = make_plan(b, t, hq, hkv, d, mb);
  return p.tile | p.splits << 1 | p.rows << 8;
}

// Plain C entry point (bound with ctypes): q (b, t, hq, d), kpool / vpool
// (nb, bs, hkv, d), out (b, t, hq, d) like q; table (b, mb), start (b,),
// kv_lens (b,) int32; all device pointers, the pools 16-byte aligned.
// q_code / kv_code: 0 float32, 1 bfloat16.  Needs hq % hkv == 0, d a
// multiple of 8 up to 128 and the plan's shared memory within a block's.
// One launch; returns its cudaError_t and never synchronizes.
extern "C" int paged_attention_launch(const void* q, const void* kpool, const void* vpool,
                                      const int* table, const int* start, const int* kv_lens,
                                      void* out, int q_code, int kv_code, int b, int t, int hq,
                                      int hkv, int d, int bs, int mb, float scale, int device,
                                      void* stream) {
  const int elem = kv_code ? 2 : 4;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && (!shapes_ok(b, t, hq, hkv, d, bs, mb, elem) || q_code < 0 ||
                           q_code > 1 || kv_code < 0 || kv_code > 1 ||
                           reinterpret_cast<uintptr_t>(kpool) % 16 ||
                           reinterpret_cast<uintptr_t>(vpool) % 16))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    const Plan p = make_plan(b, t, hq, hkv, d, mb);
    Args a;
    a.q = q;
    a.kpool = static_cast<const uint8_t*>(kpool);
    a.vpool = static_cast<const uint8_t*>(vpool);
    a.table = table;
    a.start = start;
    a.kv_lens = kv_lens;
    a.out = out;
    a.q_code = q_code;
    a.t = t;
    a.hq = hq;
    a.hkv = hkv;
    a.d = d;
    a.bs = bs;
    a.mb = mb;
    a.rows = p.rows;
    a.splits = p.splits;
    a.units = d * elem / 16;
    a.swz = swizzle_mask(a.units);
    a.cg = split_cg(p.rows, bs);
    a.scale = scale;
    a.lay = make_layout(p, d, bs, elem);
    cudaStream_t s = (cudaStream_t)stream;
    e = kv_code ? dispatch<__nv_bfloat16>(p, a, b, device, s) : dispatch<float>(p, a, b, device, s);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

#if PA_MARKS
// Where the marking build writes its marks (blocks x kMarks, ns).
extern "C" int paged_attention_set_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(paged_attention_marks, &marks, sizeof(marks));
}
#endif
